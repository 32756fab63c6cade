"""Models ported so far: the dense decoder on the paged serving path."""
from .transformer import DecoderLM, get_model  # noqa: F401
