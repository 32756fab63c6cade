"""On-device Bebop page decode: ``[N, stride]`` u8 page -> typed columns.

A page of N fixed-layout records is a dense byte matrix whose column
layout is known when the schema is compiled, so decoding is a layout
transformation: slice columns, compose little-endian bytes, widen.  The
CUDA kernel (``csrc/bebop_decode.cu``) does it for a whole decode plan in
one launch; this module holds its wrapper, its plain PyTorch version and
its launch counters.

A plan field is ``(offset, count, wire_dtype, out_dtype)``.  Wire dtypes:
``uint32``, ``int32``, ``float32`` (4 bytes), ``uint16``, ``bfloat16``,
``float16`` (2), ``uint8``/``byte``/``bool`` (1).  Integer wires take the
unsigned value of their bytes and convert it to any of ``uint8``,
``uint16``, ``int32``, ``uint32`` (wrapping) or ``float32`` (rounding),
as the TPU kernel's ``astype`` does; float wires decode to ``float32``.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import build

WIRE_CODES = {"uint32": 0, "int32": 1, "float32": 2, "uint16": 3,
              "bfloat16": 4, "float16": 5, "uint8": 6, "byte": 6, "bool": 6}
OUT_CODES = {"uint8": 0, "uint16": 1, "int32": 2, "uint32": 3, "float32": 4}
OUT_DTYPES = {"uint8": torch.uint8, "uint16": torch.uint16,
              "int32": torch.int32, "uint32": torch.uint32,
              "float32": torch.float32}
_WIDTH = {"uint32": 4, "int32": 4, "float32": 4, "uint16": 2, "bfloat16": 2,
          "float16": 2, "uint8": 1, "byte": 1, "bool": 1}
_FLOAT_WIRES = ("float32", "bfloat16", "float16")
_MAX_FIELDS = 32   # kMaxFields in csrc/bebop_decode.cu

Field = Tuple[int, int, str, str]


def default_out(wire_dtype: str) -> str:
    """What a column decodes to when its plan names no out dtype (the TPU
    kernel's ``_default_out``)."""
    return {"uint32": "uint32", "int32": "int32", "float32": "float32",
            "uint16": "uint16", "bfloat16": "float32", "float16": "float32",
            "uint8": "uint8", "byte": "uint8", "bool": "uint8"}[wire_dtype]


def _check_fields(pages: torch.Tensor, fields: Sequence) -> List[Field]:
    if pages.dim() != 2 or pages.dtype != torch.uint8:
        raise ValueError(f"pages must be [N, stride] uint8, got "
                         f"{pages.dtype} {tuple(pages.shape)}")
    stride = pages.shape[1]
    out: List[Field] = []
    for off, cnt, wd, od in fields:
        if wd not in WIRE_CODES:
            raise ValueError(f"unsupported wire dtype {wd}")
        od = str(od)
        if od not in OUT_CODES:
            raise ValueError(f"unsupported out dtype {od}")
        if wd in _FLOAT_WIRES and od != "float32":
            raise ValueError(f"{wd} wire decodes to float32, not {od}")
        if off < 0 or cnt < 0 or off + _WIDTH[wd] * cnt > stride:
            raise ValueError(f"field ({off}, {cnt}, {wd}) overruns stride "
                             f"{stride}")
        out.append((int(off), int(cnt), wd, od))
    if len(out) > _MAX_FIELDS:
        raise ValueError(f"{len(out)} fields; a plan holds {_MAX_FIELDS}")
    return out


# -- plain PyTorch version --------------------------------------------------


def _f16_bits_to_f32(h: torch.Tensor) -> torch.Tensor:
    """IEEE binary16 bits (int64) -> float32, in integer arithmetic so
    every device gives the same bits: exact, NaN payload kept and quieted
    (what the host converters and the kernel do)."""
    sign = (h & 0x8000) << 16
    exp = (h >> 10) & 0x1F
    mant = h & 0x3FF
    normal = ((exp + 112) << 23) | (mant << 13)
    special = 0x7F800000 | (mant << 13) | torch.where(
        mant != 0, 0x00400000, 0)
    sub = (mant.to(torch.float32) * 2.0 ** -24).view(torch.int32) \
        .to(torch.int64)
    bits = torch.where(exp == 0x1F, special,
                       torch.where(exp == 0, sub, normal)) | sign
    return _wrap(bits, 32).to(torch.int32).view(torch.float32)


def _wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def _decode_field_plain(pages: torch.Tensor, offset: int, count: int,
                        wire: str, out: str) -> torch.Tensor:
    n = pages.shape[0]
    w = _WIDTH[wire]
    b = pages[:, offset:offset + w * count].reshape(n, count, w) \
        .to(torch.int64)
    v = b[..., 0]
    for i in range(1, w):
        v = v | (b[..., i] << (8 * i))
    if wire == "float32":
        return _wrap(v, 32).to(torch.int32).view(torch.float32)
    if wire == "bfloat16":
        return _wrap(v << 16, 32).to(torch.int32).view(torch.float32)
    if wire == "float16":
        return _f16_bits_to_f32(v)
    if out == "float32":
        return v.to(torch.float32)
    if out == "uint8":
        return (v & 0xFF).to(torch.uint8)
    if out == "uint16":
        return _wrap(v, 16).to(torch.int16).view(torch.uint16)
    col = _wrap(v, 32).to(torch.int32)
    return col.view(torch.uint32) if out == "uint32" else col


def decode_columns_plain(pages: torch.Tensor, fields: Sequence
                         ) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`decode_columns`, on any device."""
    return [_decode_field_plain(pages, *f)
            for f in _check_fields(pages, fields)]


# -- CUDA kernel ------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = build.load("bebop_decode")
    fn = lib.bebop_decode_columns
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(pages: torch.Tensor, fields: List[Field], wrapper
            ) -> List[torch.Tensor]:
    """Run the kernel and count the launch on ``wrapper``."""
    lib = _lib()
    if not pages.is_cuda:
        raise ValueError(f"decode kernel needs a CUDA tensor, got "
                         f"{pages.device}")
    pages = pages.contiguous()
    n, stride = pages.shape
    outs = [torch.empty((n, cnt), dtype=OUT_DTYPES[od], device=pages.device)
            for (_, cnt, _, od) in fields]
    live = [(f, o) for f, o in zip(fields, outs) if o.numel()]
    if n == 0 or not live:
        return outs
    k = len(live)
    with torch.cuda.device(pages.device):   # launch on the tensor's card
        err = lib.bebop_decode_columns(
            pages.data_ptr(), n, stride, k,
            (ctypes.c_longlong * k)(*[f[0] for f, _ in live]),
            (ctypes.c_longlong * k)(*[f[1] for f, _ in live]),
            (ctypes.c_int * k)(*[WIRE_CODES[f[2]] for f, _ in live]),
            (ctypes.c_int * k)(*[OUT_CODES[f[3]] for f, _ in live]),
            (ctypes.c_void_p * k)(*[o.data_ptr() for _, o in live]),
            torch.cuda.current_stream(pages.device).cuda_stream)
    build.check(err, "bebop_decode_columns")
    build.count_launch(wrapper)
    return outs


def decode_columns(pages: torch.Tensor, fields: Sequence
                   ) -> List[torch.Tensor]:
    """Decode every field of a plan in ONE pass over the page bytes.

    ``pages``: ``[N, stride]`` uint8, any N (the kernel masks the ragged
    edge).  Returns one ``[N, count]`` tensor per field.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    """
    fields = _check_fields(pages, fields)
    if pages.device.type == "cpu":
        return decode_columns_plain(pages, fields)
    return _launch(pages, fields, decode_columns)


decode_columns.launches = 0


def decode_column(pages: torch.Tensor, *, offset: int, count: int,
                  wire_dtype: str, out_dtype=None) -> torch.Tensor:
    """One fixed-width column: a one-field plan through the same kernel."""
    fields = _check_fields(pages, [(offset, count, wire_dtype,
                                    out_dtype or default_out(wire_dtype))])
    if pages.device.type == "cpu":
        return decode_columns_plain(pages, fields)[0]
    return _launch(pages, fields, decode_column)[0]


decode_column.launches = 0
