"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,              # per-expert FFN width
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, num_shared=4, d_expert=1408),
))
