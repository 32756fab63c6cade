"""Models ported so far: the dense decoder (paged and dense serving) and
the hybrid RecurrentGemma model (dense serving)."""
from .transformer import DecoderLM, HybridLM, get_model  # noqa: F401
