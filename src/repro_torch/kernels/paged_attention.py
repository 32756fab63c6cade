"""Paged attention: block-table K/V gathers with fixed strides.

Two entry points over one pool of fixed-size KV blocks
(``serving/kv_cache.py``), both served by ``csrc/paged_attention.cu``:

  * :func:`paged_attention` — decode: ONE new token per row attends over
    its first ``ctx`` keys.
  * :func:`paged_prefill_attention` — a ``T``-token query tile per row
    (a prompt chunk, a decode row padded to the chunk width, or a
    speculative draft to verify) with per-query positions: key ``s``
    reaches query ``t`` iff ``s <= qpos[t]``, so in-chunk causality and
    history masking are the same arithmetic.

Pools are ``[N, Hkv, bs, D]`` (one layer's slice), block tables ``[B, M]``
int32 (logical block j of row b lives at physical block
``table[b, j]``).  A row with no valid key (decode ``ctx == 0``) emits
zeros, as the TPU kernel does; the plain version here follows the kernel
in that, where the JAX package's ``ref.paged_attention`` would give the
mean of V.  Out-of-range table entries are clamped, as an XLA gather
clamps them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# -- plain PyTorch version --------------------------------------------------


def paged_prefill_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  qpos: torch.Tensor, *,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Plain version of :func:`paged_prefill_attention`, on any device.

    Gathers each row's ``[Hkv, M*bs, D]`` history through its table and
    takes a masked softmax in fp32 (queries scaled before the dot, as in
    the kernels); rows with no valid key give zeros.
    """
    b, hq, t, d = q.shape
    n, hkv, bs, _ = k_pool.shape
    g = hq // hkv
    m = block_tables.shape[1]
    scale = d ** -0.5 if scale is None else scale
    tbl = block_tables.long().clamp(0, n - 1)
    k = k_pool[tbl].permute(0, 2, 1, 3, 4).reshape(b, hkv, m * bs, d).float()
    v = v_pool[tbl].permute(0, 2, 1, 3, 4).reshape(b, hkv, m * bs, d).float()
    qr = q.reshape(b, hkv, g, t, d).float() * scale
    s = torch.einsum("bhgtd,bhsd->bhgts", qr, k)
    kpos = torch.arange(m * bs, device=q.device)
    valid = kpos[None, None, :] <= qpos.long()[:, :, None]      # [B, T, S]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    mx = s.amax(-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    p = torch.exp(s - mx)
    denom = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgts,bhsd->bhgtd", p, v) \
        / torch.where(denom == 0, torch.ones_like(denom), denom)
    return o.reshape(b, hq, t, d).to(q.dtype)


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          ctx_lens: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`paged_attention`, on any device."""
    qpos = (ctx_lens.long() - 1)[:, None]
    return paged_prefill_attention_plain(q[:, :, None, :], k_pool, v_pool,
                                         block_tables, qpos,
                                         scale=scale)[:, :, 0, :]


# -- CUDA kernels -----------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    ints = [ctypes.c_int] * 8
    for fn, n_shape in ((lib.paged_attention_decode, 7),
                        (lib.paged_prefill_attention, 8)):
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                           + ints[:n_shape] + [ctypes.c_float,
                                               ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _head_dim_ok(dtype: torch.dtype, d: int) -> bool:
    """The head dims the kernel takes (csrc/paged_attention.cu dispatch):
    bf16 64, 128 or 256; float32 any multiple of 4 up to 512."""
    if dtype == torch.bfloat16:
        return d in (64, 128, 256)
    return d % 4 == 0 and 0 < d <= 512


def _check(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
           block_tables: torch.Tensor, d: int) -> None:
    if not (q.is_cuda and k_pool.is_cuda and v_pool.is_cuda
            and block_tables.is_cuda):
        raise ValueError("paged attention kernel needs CUDA tensors")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != d:
        raise ValueError(f"pools must be [N, Hkv, bs, {d}], got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if q.shape[1] % k_pool.shape[1]:
        raise ValueError(f"{q.shape[1]} q heads not a multiple of "
                         f"{k_pool.shape[1]} KV heads")
    # both bodies copy q and K/V rows as 16-byte pieces
    if not _head_dim_ok(q.dtype, d) or q.data_ptr() % 16 \
            or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(
            f"paged attention takes head_dim 64, 128 or 256 in bfloat16, a "
            f"multiple of 4 up to 512 in float32, and 16-byte-aligned q and "
            f"pools; got {q.dtype} q {tuple(q.shape)} at byte "
            f"{q.data_ptr() % 16} mod 16, pools {tuple(k_pool.shape)}")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    ctx_lens: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention through a block table.

    q: [B, Hq, D]; k_pool / v_pool: [N, Hkv, bs, D]; block_tables: [B, M];
    ctx_lens: [B] (keys 0..ctx-1 of each row participate).  Returns
    [B, Hq, D].  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     ctx_lens, scale=scale)
    build.refuse_grad(paged_attention, q, k_pool, v_pool)
    lib = _lib()
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), \
        v_pool.contiguous()
    b, hq, d = q.shape
    _check(q, k_pool, v_pool, block_tables, d)
    n, hkv, bs, _ = k_pool.shape
    tables = block_tables.to(torch.int32).contiguous()
    ctx = ctx_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    build.launch(
        lib.paged_attention_decode, q.device,
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), tables.data_ptr(), ctx.data_ptr(),
        out.data_ptr(), b, hq, hkv, d, bs, tables.shape[1], n,
        d ** -0.5 if scale is None else scale)
    build.count_launch(paged_attention)
    return out


paged_attention.launches = 0


def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            qpos: torch.Tensor, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Multi-token (chunked-prefill / mixed-step / verify) paged attention.

    q: [B, Hq, T, D]; pools and tables as :func:`paged_attention`; qpos:
    [B, T] absolute positions of the queries.  Returns [B, Hq, T, D].  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool, block_tables,
                                             qpos, scale=scale)
    build.refuse_grad(paged_prefill_attention, q, k_pool, v_pool)
    lib = _lib()
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), \
        v_pool.contiguous()
    b, hq, t, d = q.shape
    _check(q, k_pool, v_pool, block_tables, d)
    n, hkv, bs, _ = k_pool.shape
    tables = block_tables.to(torch.int32).contiguous()
    qp = qpos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    build.launch(
        lib.paged_prefill_attention, q.device,
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), tables.data_ptr(), qp.data_ptr(),
        out.data_ptr(), b, hq, hkv, t, d, bs, tables.shape[1], n,
        d ** -0.5 if scale is None else scale)
    build.count_launch(paged_prefill_attention)
    return out


paged_prefill_attention.launches = 0
