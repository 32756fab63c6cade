"""Models: the decoder (dense or MoE GQA layers from tokens, paged and
dense serving; from embeddings with M-RoPE, dense serving; RWKV6 layers,
dense serving), the hybrid RecurrentGemma model and the encoder-decoder
Seamless backbone (dense serving)."""
from .transformer import DecoderLM, EncDecLM, HybridLM, get_model  # noqa: F401
