"""gemma-2b — GeGLU, head_dim=256, MQA (kv=1) [arXiv:2403.08295]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,         # MQA on the 2b
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_act="geglu",
    tie_embeddings=True,    # gemma ties input/output embeddings
))
