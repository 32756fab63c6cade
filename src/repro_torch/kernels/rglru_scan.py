"""RG-LRU recurrence (RecurrentGemma): a gated diagonal linear scan.

    h_t = a_t * h_{t-1} + x_t,   h_{-1} = 0

x and a are ``[B, T, D]``: ``a_t`` the per-step decay and ``x_t`` the
already gated and scaled input (``models/rglru.py`` computes both).  The
result is ``(h [B, T, D]`` in the dtype of x, ``h_final [B, D]`` float32),
with the state carried in float32.  :func:`rglru_scan` launches
``csrc/rglru_scan.cu`` for CUDA tensors and runs :func:`rglru_scan_plain`
for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rglru_scan_plain(x: torch.Tensor, a: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rglru_scan`, on any device: a loop over T
    of one float32 multiply and one add (the JAX ``ref.rglru``)."""
    b, t, d = x.shape
    h = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    out = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    for i in range(t):
        h = a[:, i].float() * h + x[:, i].float()
        out[:, i] = h.to(x.dtype)
    return out, h


def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    if lib.rglru_scan.argtypes is None:
        lib.rglru_scan.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.rglru_scan.restype = ctypes.c_int
    return lib


def rglru_scan(x: torch.Tensor, a: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, a: [B, T, D] -> (h [B, T, D], h_final [B, D] float32).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if x.device.type == "cpu":
        return rglru_scan_plain(x, a)
    build.refuse_grad(rglru_scan, x, a)
    lib = _lib()
    if not (x.is_cuda and a.is_cuda):
        raise ValueError("rglru scan kernel needs CUDA tensors")
    if x.dtype not in _DTYPE_CODES or a.dtype != x.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 x and a of one "
                         f"dtype, got {x.dtype}/{a.dtype}")
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"need x, a [B, T, D] of one shape, got "
                         f"{tuple(x.shape)} / {tuple(a.shape)}")
    b, t, d = x.shape
    x, a = x.contiguous(), a.contiguous()
    h = torch.empty_like(x)
    h_final = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    if b == 0 or t == 0 or d == 0:
        return h, h_final
    build.launch(
        lib.rglru_scan, x.device,
        _DTYPE_CODES[x.dtype], x.data_ptr(), a.data_ptr(), h.data_ptr(),
        h_final.data_ptr(), b, t, d)
    build.count_launch(rglru_scan)
    return h, h_final


rglru_scan.launches = 0
