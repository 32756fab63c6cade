"""Architecture configs (every one the JAX package registers) + the
registry."""
from .base import (ModelConfig, MoEConfig, get_config,  # noqa: F401
                   reduced_config, register)

_LOADED = False

ARCH_IDS = [
    "rwkv6-7b", "gemma-2b", "qwen2-1.5b", "yi-34b", "qwen2-72b",
    "qwen2-moe-a2.7b", "granite-moe-1b-a400m", "qwen2-vl-2b",
    "seamless-m4t-medium", "recurrentgemma-9b",
]


def load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    from . import (rwkv6_7b, gemma_2b, qwen2_1_5b, yi_34b,  # noqa: F401
                   qwen2_72b, qwen2_moe_a2_7b, granite_moe_1b_a400m,
                   qwen2_vl_2b, seamless_m4t_medium, recurrentgemma_9b)
    _LOADED = True
