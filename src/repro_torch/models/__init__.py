"""Models ported so far: the decoder (dense GQA layers, paged and dense
serving; RWKV6 layers, dense serving) and the hybrid RecurrentGemma model
(dense serving)."""
from .transformer import DecoderLM, HybridLM, get_model  # noqa: F401
