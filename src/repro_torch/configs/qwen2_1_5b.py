"""qwen2-1.5b — GQA kv=2, QKV bias [arXiv:2407.10671]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))
