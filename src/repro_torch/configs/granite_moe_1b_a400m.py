"""granite-moe-1b-a400m — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,               # per-expert FFN width
    vocab_size=49155,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, num_shared=0, d_expert=512),
))
