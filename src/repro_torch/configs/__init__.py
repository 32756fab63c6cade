"""Architecture configs ported so far + the registry."""
from .base import (ModelConfig, MoEConfig, get_config,  # noqa: F401
                   reduced_config, register)

_LOADED = False

ARCH_IDS = ["rwkv6-7b", "gemma-2b", "qwen2-1.5b", "yi-34b", "qwen2-72b",
            "recurrentgemma-9b"]


def load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    from . import (rwkv6_7b, gemma_2b, qwen2_1_5b, yi_34b,  # noqa: F401
                   qwen2_72b, recurrentgemma_9b)
    _LOADED = True
