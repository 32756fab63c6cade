"""recurrentgemma-9b — Griffin: RG-LRU + local attention, 1:2
[arXiv:2402.19427].

38 layers = 12 x (rec, rec, attn) + (rec, rec) tail.  Local attention
window 2048, MQA (kv=1), head_dim=256, GeGLU.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mlp_act="geglu",
    tie_embeddings=True,
    attention_kind="local",
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    tail_pattern=("rec", "rec"),
    lru_width=4096,
    conv_width=4,
))
