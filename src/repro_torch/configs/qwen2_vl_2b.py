"""qwen2-vl-2b — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision frontend is a stub: the caller passes precomputed patch
embeddings (``batch["embeds"]``) with their (t, h, w) position triplets
(``batch["positions"]``, [3, B, T]); the backbone applies M-RoPE over them
with head_dim sections (16, 24, 24).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
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
    mrope=True,
    mrope_sections=(16, 24, 24),
    input_kind="embeddings",
))
