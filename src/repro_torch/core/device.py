"""Device rule + decode planning: Bebop struct -> device column layout.

Copied from the JAX package's ``core/device.py``: the schema's wire
layout is fixed at compile time, so every column's ``(offset, count,
dtype)`` is planned once and handed to the decode kernel.  A column is
device-decodable only if its byte offset is a multiple of its element
size (the alignment rule the paper's C generator gets by sorting fields).
:func:`decode_page_device` decodes a ``[N, stride]`` u8 payload by its
layout in one launch of the page decode kernel.

:func:`torch_device` is the port's device rule for every entry point:
CUDA unless the caller asks for the CPU, and an error, never a silent
CPU run, when CUDA is asked for and there is none.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..kernels import bebop_decode
from . import types as T
from .fastwire import static_dtype

_WIRE_NAMES = {
    "uint32": ("uint32", 4), "int32": ("int32", 4), "float32": ("float32", 4),
    "uint16": ("uint16", 2), "bfloat16": ("bfloat16", 2),
    "float16": ("float16", 2), "byte": ("uint8", 1), "uint8": ("uint8", 1),
    "bool": ("uint8", 1), "int8": ("uint8", 1),
}


def torch_device(device) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    Raises when a CUDA device is asked for and none is available: the
    port never quietly runs its plain path in place of the card.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    name: str
    offset: int
    count: int
    wire_dtype: str
    elem_size: int

    def as_field(self, out_dtype: str) -> Tuple[int, int, str, str]:
        return (self.offset, self.count, self.wire_dtype, out_dtype)


@dataclasses.dataclass(frozen=True)
class DeviceLayout:
    struct_name: str
    stride: int
    columns: Tuple[ColumnSpec, ...]


def _field_column(name: str, ft: T.Type, offset: int) -> Optional[ColumnSpec]:
    if isinstance(ft, T.FixedArray) and isinstance(ft.elem, T.Prim):
        wn = _WIRE_NAMES.get(ft.elem.name)
        if wn is None:
            return None
        return ColumnSpec(name, offset, ft.count, wn[0], wn[1])
    if isinstance(ft, T.Prim):
        if ft.name == "uuid" or ft.name in ("int128", "uint128"):
            return ColumnSpec(name, offset, 16, "uint8", 1)
        wn = _WIRE_NAMES.get(ft.name)
        if wn is None:
            return None
        return ColumnSpec(name, offset, 1, wn[0], wn[1])
    return None


def plan_device_layout(s: T.Struct) -> DeviceLayout:
    """Static column plan for a fixed-layout struct."""
    dt = static_dtype(s)
    if dt is None:
        raise T.SchemaError(
            f"struct {s.name} is not fixed-layout; device decode requires "
            f"static strides (use fixed arrays / shape-specialized pages)")
    cols: List[ColumnSpec] = []
    offset = 0
    for f in s.fields:
        size = f.type.static_size()
        col = _field_column(f.name, f.type, offset)
        if col is not None:
            if col.offset % col.elem_size != 0:
                raise T.SchemaError(
                    f"{s.name}.{f.name}: offset {col.offset} not aligned to "
                    f"element size {col.elem_size}; reorder fields")
            cols.append(col)
        offset += size
    return DeviceLayout(s.name, dt.itemsize, tuple(cols))


def decode_page_device(payload_u8: torch.Tensor, layout: DeviceLayout,
                       out_dtypes: Optional[Dict[str, str]] = None
                       ) -> Dict[str, torch.Tensor]:
    """[N, stride] u8 tensor -> {column name: [N, count] decoded tensor}.

    Every column goes through one :func:`~repro_torch.kernels.bebop_decode.
    decode_columns` call: on a CUDA tensor the kernel, on a CPU tensor its
    plain version.  A column decodes to ``out_dtypes[name]``, or to
    :func:`default_out_dtype` of its wire dtype.  (The JAX version's
    ``impl`` and ``block_n`` choose its kernel's path and tile; the tensor's
    device does the first here, and the CUDA kernel sizes its own tiles.)
    """
    if payload_u8.shape[1] != layout.stride:
        raise T.DecodeError(
            f"payload stride {payload_u8.shape[1]} != layout {layout.stride}")
    out_dtypes = out_dtypes or {}
    fields = tuple(
        c.as_field(out_dtypes.get(c.name, default_out_dtype(c.wire_dtype)))
        for c in layout.columns)
    outs = bebop_decode.decode_columns(payload_u8, fields)
    return {c.name: o for c, o in zip(layout.columns, outs)}


def default_out_dtype(wire_dtype: str) -> str:
    """Model-facing dtype a wire column decodes to unless overridden."""
    return {"uint32": "int32", "int32": "int32", "float32": "float32",
            "uint16": "uint16", "bfloat16": "float32", "float16": "float32",
            "uint8": "uint8"}[wire_dtype]
