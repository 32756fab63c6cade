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
import sys
from typing import Dict, List, Sequence, Tuple

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


class _Plan:
    """A checked plan and what the kernel needs of it, built once per
    ``fields`` tuple (:func:`_plan`): the page-independent half of every
    call."""

    def __init__(self, fields: Tuple[Field, ...]):
        self.fields = fields
        # the narrowest page every field fits in; a negative offset or
        # count fits in none
        self.min_stride = max(
            [off + _WIDTH[wd] * cnt if off >= 0 and cnt >= 0 else sys.maxsize
             for off, cnt, wd, _ in fields], default=0)
        self.out_dtypes = [OUT_DTYPES[od] for *_, od in fields]
        # fields with elements: the only ones the kernel sees
        self.live = [i for i, f in enumerate(fields) if f[1] > 0]
        self.packed = _PackedPlan(len(self.live), tuple(
            _PackedField(fields[i][0], fields[i][1], WIRE_CODES[fields[i][2]],
                         OUT_CODES[fields[i][3]]) for i in self.live))
        self.packed_addr = ctypes.addressof(self.packed)

    def check_stride(self, stride: int) -> None:
        if stride >= self.min_stride:
            return
        for off, cnt, wd, _ in self.fields:
            if off < 0 or cnt < 0 or off + _WIDTH[wd] * cnt > stride:
                raise ValueError(f"field ({off}, {cnt}, {wd}) overruns "
                                 f"stride {stride}")


class _PackedField(ctypes.Structure):
    _fields_ = [("offset", ctypes.c_int), ("count", ctypes.c_int),
                ("wire", ctypes.c_int), ("out", ctypes.c_int)]


class _PackedPlan(ctypes.Structure):
    """``Plan`` in csrc/bebop_decode.cu."""
    _fields_ = [("n_fields", ctypes.c_int),
                ("f", _PackedField * _MAX_FIELDS)]


#: ``fields`` tuple -> its :class:`_Plan`.  Plans are per schema, so the
#: cache stays small; a race builds one plan twice, and either is right.
_PLANS: Dict[tuple, _Plan] = {}


def _plan(fields: Sequence) -> _Plan:
    """The cached :class:`_Plan` of ``fields``, keyed by the whole tuple:
    plans that differ in any offset, count or code never share an entry."""
    try:
        return _PLANS[fields]
    except KeyError:                # new
        alias = fields
    except TypeError:               # unhashable (lists): key by its tuple
        alias = None
    key = tuple(tuple(f) for f in fields)
    plan = _PLANS.get(key)
    if plan is None:
        checked = []
        for off, cnt, wd, od in key:
            if wd not in WIRE_CODES:
                raise ValueError(f"unsupported wire dtype {wd}")
            od = str(od)
            if od not in OUT_CODES:
                raise ValueError(f"unsupported out dtype {od}")
            if wd in _FLOAT_WIRES and od != "float32":
                raise ValueError(f"{wd} wire decodes to float32, not {od}")
            checked.append((int(off), int(cnt), wd, od))
        if len(checked) > _MAX_FIELDS:
            raise ValueError(f"{len(checked)} fields; a plan holds "
                             f"{_MAX_FIELDS}")
        plan = _PLANS[key] = _Plan(tuple(checked))
    if alias is not None:
        _PLANS[alias] = plan
    return plan


def _check_fields(pages: torch.Tensor, fields: Sequence) -> _Plan:
    if pages.dim() != 2 or pages.dtype != torch.uint8:
        raise ValueError(f"pages must be [N, stride] uint8, got "
                         f"{pages.dtype} {tuple(pages.shape)}")
    plan = _plan(fields)
    plan.check_stride(pages.shape[1])
    return plan


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
            for f in _check_fields(pages, fields).fields]


# -- CUDA kernel ------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = build.load("bebop_decode")
    fn = lib.bebop_decode_columns
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(pages: torch.Tensor, plan: _Plan, wrapper) -> List[torch.Tensor]:
    """Run the kernel and count the launch on ``wrapper``.  Only what
    depends on the page is done here: its pointer, N, the outputs."""
    lib = _lib()
    if not pages.is_cuda:
        raise ValueError(f"decode kernel needs a CUDA tensor, got "
                         f"{pages.device}")
    pages = pages.contiguous()
    n, stride = pages.shape
    dev = pages.device
    outs = [torch.empty((n, f[1]), dtype=dt, device=dev)
            for f, dt in zip(plan.fields, plan.out_dtypes)]
    if n == 0 or not plan.live:
        return outs
    ptrs = (ctypes.c_void_p * len(plan.live))(
        *[outs[i].data_ptr() for i in plan.live])
    build.launch(lib.bebop_decode_columns, dev, plan.packed_addr,
                 pages.data_ptr(), n, stride, ptrs)
    build.count_launch(wrapper)
    return outs


def decode_columns(pages: torch.Tensor, fields: Sequence
                   ) -> List[torch.Tensor]:
    """Decode every field of a plan in ONE pass over the page bytes.

    ``pages``: ``[N, stride]`` uint8, any N (the kernel masks the ragged
    edge).  Returns one ``[N, count]`` tensor per field.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    """
    if pages.device.type != "cpu":
        build.refuse_grad(decode_columns, pages)
    plan = _check_fields(pages, fields)
    if pages.device.type == "cpu":
        return [_decode_field_plain(pages, *f) for f in plan.fields]
    return _launch(pages, plan, decode_columns)


decode_columns.launches = 0


def decode_column(pages: torch.Tensor, *, offset: int, count: int,
                  wire_dtype: str, out_dtype=None) -> torch.Tensor:
    """One fixed-width column: a one-field plan through the same kernel."""
    if pages.device.type != "cpu":
        build.refuse_grad(decode_column, pages)
    plan = _check_fields(pages, ((offset, count, wire_dtype,
                                  out_dtype or default_out(wire_dtype)),))
    if pages.device.type == "cpu":
        return _decode_field_plain(pages, *plan.fields[0])
    return _launch(pages, plan, decode_column)[0]


decode_column.launches = 0
