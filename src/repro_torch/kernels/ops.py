"""Attention entry point the models call.

The decode kernels need no dispatch layer: each wrapper in
:mod:`.bebop_decode` and :mod:`.paged_attention` already runs its plain
version for a CPU tensor and launches its kernel (or raises) for a CUDA
tensor.  What is left to dispatch is the query width, as in the JAX
package's ``ops.paged_attention``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import paged_attention as _pa


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
    if impl == "reference":
        return _pa.paged_prefill_attention_plain(q, k_pool, v_pool,
                                                 block_tables, qpos,
                                                 scale=scale)
    if impl != "kernel":
        raise ValueError(f"unknown attention impl {impl!r}")
    if q.shape[2] == 1:
        out = _pa.paged_attention(q[:, :, 0, :], k_pool, v_pool,
                                  block_tables, qpos[:, 0] + 1, scale=scale)
        return out[:, :, None, :]
    return _pa.paged_prefill_attention(q, k_pool, v_pool, block_tables, qpos,
                                       scale=scale)
