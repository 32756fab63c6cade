"""rwkv6-7b — Finch: attention-free, data-dependent decay [arXiv:2404.05892].

32L d_model=4096 d_ff=14336 vocab=65536.  head_dim=64 -> 64 WKV heads.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,           # 4096 / 64 WKV head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    attention_kind="none",
    rwkv=True,
    rwkv_head_dim=64,
    time_mix_extra_dim=32,
    decay_extra_dim=64,
))
