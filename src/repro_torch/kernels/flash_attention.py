"""Blockwise (flash) attention over a dense K/V: GQA, causal, sliding
window, query offset.

q ``[B, Hq, Tq, D]``, k/v ``[B, Hkv, S, D]`` with ``Hq % Hkv == 0``; the
result is ``[B, Hq, Tq, D]`` in the dtype of q.  Query ``t`` sits at
absolute position ``t + q_offset``; key ``s`` reaches it iff
``(not causal or s <= pos) and (window is None or pos - s < window)``.
A row with no valid key gives zeros.  This is ``ref.attention`` of the
JAX package; its TPU kernel (``kernels/flash_attention.py``) would give
the mean of V for such a row where it processes the masked block, and
the port follows the reference (``ROADMAP.md``, Queue 3).

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors (float32 or bfloat16, head_dim 64, 128 or 256, any ``Tq`` and
``S``)
and runs :func:`flash_attention_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for (seamless-m4t-medium; qwen2-1.5b,
#: qwen2-vl-2b; recurrentgemma-9b)
KERNEL_HEAD_DIMS = (64, 128, 256)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain version of :func:`flash_attention`, on any device: masked
    softmax in float32 over the full ``[Tq, S]`` score tensor, the JAX
    package's ``ref.attention`` step for step."""
    b, hq, tq, d = q.shape
    _, hkv, s, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} q heads not a multiple of {hkv} KV heads")
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qr = q.reshape(b, hkv, g, tq, d).float()
    logits = torch.einsum("bhgtd,bhsd->bhgts", qr, k.float()) * scale
    qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((tq, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # fully masked rows: softmax of -inf is nan -> 0
    probs = torch.where(torch.isnan(probs), torch.zeros_like(probs), probs)
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, v.float())
    return out.reshape(b, hq, tq, d).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash attention kernel needs CUDA tensors")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"need q [B, Hq, Tq, D] and k, v [B, Hkv, S, D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernel supports head_dim "
                         f"{KERNEL_HEAD_DIMS}, got {q.shape[3]}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"{q.shape[1]} q heads not a multiple of "
                         f"{k.shape[1]} KV heads")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Dense GQA attention (see the module docstring for the masks).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset)
    lib = _lib()
    _check(q, k, v, q_offset)
    b, hq, tq, d = q.shape
    s = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if b == 0 or tq == 0:
        return out
    if s == 0:
        return out.zero_()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs 16-byte-aligned "
                         "q, k and v")
    build.launch(
        lib.flash_attention, q.device,
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, hq, k.shape[1], tq, s, d, int(bool(causal)),
        -1 if window is None else int(window), int(q_offset),
        d ** -0.5 if scale is None else scale)
    build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
