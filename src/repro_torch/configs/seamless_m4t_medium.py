"""seamless-m4t-medium — encoder-decoder, multimodal [arXiv:2308.11596].

The speech frontend is a stub: the caller passes precomputed frame
embeddings (``batch["frames"]``; the serving engine sends zeros at
seq_len / frame_ratio frames); the backbone is the 12L+12L transformer
with cross-attention.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frame_ratio=8,
    input_kind="frames",
))
