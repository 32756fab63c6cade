"""Architecture configs ported so far + the registry."""
from .base import (ModelConfig, MoEConfig, get_config,  # noqa: F401
                   reduced_config, register)

_LOADED = False

ARCH_IDS = ["qwen2-1.5b", "recurrentgemma-9b", "rwkv6-7b"]


def load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    from . import qwen2_1_5b  # noqa: F401
    from . import recurrentgemma_9b  # noqa: F401
    from . import rwkv6_7b  # noqa: F401
    _LOADED = True
