"""Bebop wire types: the subset that fixed-layout record pages need.

Copied from the JAX package's ``core/types.py`` (primitive table,
``FixedArray``, ``Field``, ``Struct``, the error classes) and
``core/fastwire.py`` (:func:`static_dtype`), trimmed to what page
encode, page validation and device decode planning use.

Wire rules (all little-endian): bool=1, byte/int8=1, int16/uint16=2,
int32/uint32/float32=4, int64/uint64/float64=8, float16 = IEEE binary16,
bfloat16 = the high 16 bits of binary32, int128/uint128/uuid = 16 bytes,
timestamp = 16 (int64 sec, int32 ns, int32 tz offset), duration = 12.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

_PRIM_SPECS = {
    # name: (size, numpy dtype or None)
    "bool": (1, np.dtype("u1")),
    "byte": (1, np.dtype("u1")),
    "uint8": (1, np.dtype("u1")),
    "int8": (1, np.dtype("i1")),
    "int16": (2, np.dtype("<i2")),
    "uint16": (2, np.dtype("<u2")),
    "int32": (4, np.dtype("<i4")),
    "uint32": (4, np.dtype("<u4")),
    "int64": (8, np.dtype("<i8")),
    "uint64": (8, np.dtype("<u8")),
    "float32": (4, np.dtype("<f4")),
    "float64": (8, np.dtype("<f8")),
    "float16": (2, np.dtype("<f2")),
    # bfloat16 has no numpy scalar; stored as <u2 raw bits.
    "bfloat16": (2, np.dtype("<u2")),
    "int128": (16, None),
    "uint128": (16, None),
    "uuid": (16, None),
    "timestamp": (16, None),
    "duration": (12, None),
}

ALIASES = {"half": "float16", "bf16": "bfloat16", "guid": "uuid"}

MAX_FIXED_ARRAY = 65535


class BebopError(Exception):
    """Base error for schema/wire problems."""


class SchemaError(BebopError):
    pass


class Type:
    """Base class for wire types."""

    def static_size(self) -> Optional[int]:
        raise NotImplementedError


class Prim(Type):
    __slots__ = ("name", "size", "np_dtype")

    def __init__(self, name: str):
        name = ALIASES.get(name, name)
        if name not in _PRIM_SPECS:
            raise SchemaError(f"unknown primitive: {name}")
        self.name = name
        self.size, self.np_dtype = _PRIM_SPECS[name]

    def static_size(self):
        return self.size

    def __eq__(self, other):
        return isinstance(other, Prim) and other.name == self.name

    def __hash__(self):
        return hash(("prim", self.name))

    def __repr__(self):
        return self.name


UINT32 = Prim("uint32")


class FixedArray(Type):
    """Fixed array: no prefix, compile-time element count."""

    __slots__ = ("elem", "count")

    def __init__(self, elem: Type, count: int):
        if not (0 <= count <= MAX_FIXED_ARRAY):
            raise SchemaError(f"fixed array size out of range: {count}")
        self.elem = elem
        self.count = count

    def static_size(self):
        es = self.elem.static_size()
        return None if es is None else es * self.count

    def __repr__(self):
        return f"{self.elem!r}[{self.count}]"


@dataclasses.dataclass
class Field:
    name: str
    type: Type


class Struct(Type):
    """Positional encoding, no tags, no length prefix."""

    def __init__(self, name: str, fields: Sequence[Field]):
        self.name = name
        self.fields = list(fields)
        seen = set()
        for f in self.fields:
            if f.name in seen:
                raise SchemaError(f"duplicate field {f.name} in struct {name}")
            seen.add(f.name)

    def static_size(self):
        total = 0
        for f in self.fields:
            s = f.type.static_size()
            if s is None:
                return None
            total += s
        return total

    def __repr__(self):
        return self.name


_TIMESTAMP_DT = np.dtype([("sec", "<i8"), ("ns", "<i4"), ("offset_ms", "<i4")])
_DURATION_DT = np.dtype([("sec", "<i8"), ("ns", "<i4")])


def _prim_dtype(p: Prim) -> np.dtype:
    if p.name in ("uuid", "int128", "uint128"):
        return np.dtype(("u1", (16,)))
    if p.name == "timestamp":
        return _TIMESTAMP_DT
    if p.name == "duration":
        return _DURATION_DT
    return p.np_dtype


def static_dtype(t: Type) -> Optional[np.dtype]:
    """Packed little-endian numpy dtype for a fixed-width type, else None.

    The returned dtype's itemsize equals the wire size exactly (no
    padding), so ``np.frombuffer(page, dtype=static_dtype(s))`` IS the
    host decoder.
    """
    if isinstance(t, Prim):
        return _prim_dtype(t)
    if isinstance(t, FixedArray):
        ed = static_dtype(t.elem)
        return None if ed is None else np.dtype((ed, (t.count,)))
    if isinstance(t, Struct):
        fields = []
        for f in t.fields:
            fd = static_dtype(f.type)
            if fd is None:
                return None
            fields.append((f.name, fd))
        return np.dtype(fields)
    return None
