"""Kernel entry points the models call, with the ``impl`` switch.

Each wrapper in :mod:`.bebop_decode`, :mod:`.paged_attention`,
:mod:`.flash_attention`, :mod:`.rglru_scan` and :mod:`.rwkv6_scan`
already runs its plain version for a CPU tensor and launches its kernel
(or raises) for a CUDA tensor.  What is left here is the model config's
``attention_impl``: ``"kernel"`` goes through the wrapper, ``"reference"``
calls the plain version by name on any device; and, for paged attention,
the query width, as in the JAX package's ``ops.paged_attention``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import flash_attention as _fa
from . import paged_attention as _pa
from . import rglru_scan as _rg
from . import rwkv6_scan as _rw


def _check_impl(impl: str) -> None:
    if impl not in ("kernel", "reference"):
        raise ValueError(f"unknown attention impl {impl!r}")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    qpos: torch.Tensor, *, scale: Optional[float] = None,
                    impl: str = "kernel") -> torch.Tensor:
    """Attention of new tokens against a block-pooled KV cache.

    q: [B, Hq, T, D]; pools: [N, Hkv, bs, D]; block_tables: [B, M];
    qpos: [B, T] absolute positions of the query tokens.  ``impl="kernel"``
    sends T == 1 to the decode kernel (with ``ctx = qpos[:, 0] + 1``) and
    T > 1 to the paged-prefill kernel; ``impl="reference"`` calls the plain
    version by name, on any device.
    """
    _check_impl(impl)
    if impl == "reference":
        return _pa.paged_prefill_attention_plain(q, k_pool, v_pool,
                                                 block_tables, qpos,
                                                 scale=scale)
    if q.shape[2] == 1:
        out = _pa.paged_attention(q[:, :, 0, :], k_pool, v_pool,
                                  block_tables, qpos[:, 0] + 1, scale=scale)
        return out[:, :, None, :]
    return _pa.paged_prefill_attention(q, k_pool, v_pool, block_tables, qpos,
                                       scale=scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, q_offset: int = 0,
              impl: str = "kernel") -> torch.Tensor:
    """Dense GQA attention, q [B, Hq, Tq, D], k/v [B, Hkv, S, D]."""
    _check_impl(impl)
    fn = _fa.flash_attention if impl == "kernel" \
        else _fa.flash_attention_plain
    return fn(q, k, v, causal=causal, window=window, scale=scale,
              q_offset=q_offset)


def rglru(x: torch.Tensor, a: torch.Tensor, *, impl: str = "kernel"
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU scan: x, a [B, T, D] -> (h [B, T, D], h_final [B, D])."""
    _check_impl(impl)
    fn = _rg.rglru_scan if impl == "kernel" else _rg.rglru_scan_plain
    return fn(x, a)


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, *, impl: str = "kernel"
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence: r, k, w [B, H, T, K], v [B, H, T, V], u
    [H, K] -> (o [B, H, T, V], final state [B, H, K, V] float32)."""
    _check_impl(impl)
    fn = _rw.rwkv6_scan if impl == "kernel" else _rw.rwkv6_scan_plain
    return fn(r, k, v, w, u)
