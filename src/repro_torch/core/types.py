"""Bebop wire type system.

Copied whole from the JAX package's ``core/types.py``: the message codec
(``wire.py``), the RPC wire types and the page records use every part of it.

Every Bebop type has a *fixed* wire width, or is composed of fixed-width
pieces behind a fixed-width (4-byte) length/count prefix.  This module is the
single source of truth for widths, alignment, numpy dtypes and value-level
helpers (timestamps, durations, uuids, 128-bit ints, bfloat16).

Wire rules implemented here (paper §3):
  * all multi-byte integers little-endian
  * bool=1, byte/int8=1, int16/uint16=2, int32/uint32/float32=4,
    int64/uint64/float64=8
  * int128/uint128 = 16 (low 8 bytes first)
  * float16 = 2 (IEEE binary16), bfloat16 = 2 (high 16 bits of binary32)
  * timestamp = 16 (int64 sec, int32 ns, int32 tz offset in ms)
  * duration  = 12 (int64 sec, int32 ns)
  * uuid = 16 bytes matching the canonical hex string byte-for-byte
  * string = u32 byte length + UTF-8 + 1-byte NUL terminator
  * dynamic array = u32 count + elements; fixed array = elements only
  * map = u32 count + key/value pairs
"""
from __future__ import annotations

import dataclasses
import struct as _struct
import uuid as _uuid
from typing import Dict, List, Optional, Sequence

import numpy as np

# --------------------------------------------------------------------------
# Primitive registry
# --------------------------------------------------------------------------

_PRIM_SPECS = {
    # name: (size, numpy dtype or None, struct fmt or None)
    "bool": (1, np.dtype("u1"), "<B"),
    "byte": (1, np.dtype("u1"), "<B"),
    "uint8": (1, np.dtype("u1"), "<B"),
    "int8": (1, np.dtype("i1"), "<b"),
    "int16": (2, np.dtype("<i2"), "<h"),
    "uint16": (2, np.dtype("<u2"), "<H"),
    "int32": (4, np.dtype("<i4"), "<i"),
    "uint32": (4, np.dtype("<u4"), "<I"),
    "int64": (8, np.dtype("<i8"), "<q"),
    "uint64": (8, np.dtype("<u8"), "<Q"),
    "float32": (4, np.dtype("<f4"), "<f"),
    "float64": (8, np.dtype("<f8"), "<d"),
    "float16": (2, np.dtype("<f2"), "<e"),
    # bfloat16 has no numpy scalar; stored as <u2 raw bits.
    "bfloat16": (2, np.dtype("<u2"), None),
    "int128": (16, None, None),
    "uint128": (16, None, None),
    "uuid": (16, None, None),
    "timestamp": (16, None, None),
    "duration": (12, None, None),
}

# Type aliases from §5.5.
ALIASES = {"half": "float16", "bf16": "bfloat16", "guid": "uuid"}

_INT_RANGES = {
    "byte": (0, 2**8 - 1),
    "uint8": (0, 2**8 - 1),
    "int8": (-(2**7), 2**7 - 1),
    "int16": (-(2**15), 2**15 - 1),
    "uint16": (0, 2**16 - 1),
    "int32": (-(2**31), 2**31 - 1),
    "uint32": (0, 2**32 - 1),
    "int64": (-(2**63), 2**63 - 1),
    "uint64": (0, 2**64 - 1),
    "int128": (-(2**127), 2**127 - 1),
    "uint128": (0, 2**128 - 1),
}

INTEGER_PRIMS = frozenset(_INT_RANGES)
FLOAT_PRIMS = frozenset({"float16", "bfloat16", "float32", "float64"})
# Valid map key types (§3.7): integers, bool, string, uuid.  No floats.
VALID_MAP_KEY_PRIMS = frozenset(
    {"bool", "byte", "uint8", "int8", "int16", "uint16", "int32", "uint32",
     "int64", "uint64", "uuid"}
)

MAX_FIXED_ARRAY = 65535  # §3.6
MAX_TAG = 255            # §3.9
MAX_DISCRIMINATOR = 255  # §3.10


class BebopError(Exception):
    """Base error for schema/wire problems."""


class EncodeError(BebopError):
    pass


class DecodeError(BebopError):
    pass


class SchemaError(BebopError):
    pass


# --------------------------------------------------------------------------
# Value helpers
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Timestamp:
    """Absolute point in time (§3.3.1): 16 bytes on the wire."""

    sec: int
    ns: int = 0
    offset_ms: int = 0

    def __post_init__(self):
        if not (0 <= self.ns < 1_000_000_000):
            raise ValueError(f"timestamp ns out of range: {self.ns}")

    @classmethod
    def from_unix(cls, t: float, offset_ms: int = 0) -> "Timestamp":
        sec = int(t // 1)
        ns = int(round((t - sec) * 1e9))
        if ns >= 1_000_000_000:
            sec, ns = sec + 1, ns - 1_000_000_000
        return cls(sec, ns, offset_ms)

    def to_unix(self) -> float:
        return self.sec + self.ns * 1e-9


@dataclasses.dataclass(frozen=True)
class Duration:
    """Signed time span (§3.3.2): 12 bytes on the wire.

    For negative durations both fields are negative or zero.
    """

    sec: int
    ns: int = 0

    def __post_init__(self):
        if abs(self.ns) >= 1_000_000_000:
            raise ValueError(f"duration ns out of range: {self.ns}")
        if self.sec > 0 and self.ns < 0 or self.sec < 0 and self.ns > 0:
            raise ValueError("duration sec/ns must share a sign")

    @classmethod
    def from_seconds(cls, t: float) -> "Duration":
        neg = t < 0
        a = abs(t)
        sec = int(a)
        ns = int(round((a - sec) * 1e9))
        if ns >= 1_000_000_000:
            sec, ns = sec + 1, ns - 1_000_000_000
        return cls(-sec, -ns) if neg else cls(sec, ns)

    def to_seconds(self) -> float:
        return self.sec + self.ns * 1e-9


def encode_bf16(value: float) -> int:
    """float -> bfloat16 raw bits (round-to-nearest-even on the mantissa)."""
    bits = _struct.unpack("<I", _struct.pack("<f", float(value)))[0]
    # round-to-nearest-even: add 0x7FFF + lsb of the surviving mantissa
    rounded = bits + 0x7FFF + ((bits >> 16) & 1)
    if np.isnan(np.float32(value)):
        return 0x7FC0  # canonical quiet NaN
    return (rounded >> 16) & 0xFFFF


def decode_bf16(raw: int) -> float:
    """bfloat16 raw bits -> python float."""
    return _struct.unpack("<f", _struct.pack("<I", (raw & 0xFFFF) << 16))[0]


def bf16_array_to_f32(raw: np.ndarray) -> np.ndarray:
    """Vectorized bfloat16 (as <u2 raw bits) -> float32."""
    raw = np.ascontiguousarray(raw, dtype="<u2")
    return (raw.astype("<u4") << 16).view("<f4")


def f32_array_to_bf16(arr: np.ndarray) -> np.ndarray:
    """Vectorized float32 -> bfloat16 raw bits (<u2), round-to-nearest-even."""
    bits = np.ascontiguousarray(arr, dtype="<f4").view("<u4")
    rounded = bits + 0x7FFF + ((bits >> np.uint32(16)) & np.uint32(1))
    out = (rounded >> np.uint32(16)).astype("<u2")
    nan = np.isnan(arr)
    if nan.any():
        out = np.where(nan, np.uint16(0x7FC0), out)
    return out


def encode_int128(v: int, signed: bool) -> bytes:
    lo, hi = _INT_RANGES["int128" if signed else "uint128"]
    if not (lo <= v <= hi):
        raise EncodeError(f"int128 out of range: {v}")
    return int(v).to_bytes(16, "little", signed=signed)


def decode_int128(b: bytes, signed: bool) -> int:
    return int.from_bytes(b, "little", signed=signed)


def uuid_to_wire(u) -> bytes:
    """UUID -> 16 bytes matching the canonical hex string byte-for-byte (§3.4)."""
    if isinstance(u, _uuid.UUID):
        return u.bytes  # big-endian field order == canonical string order
    if isinstance(u, (bytes, bytearray)) and len(u) == 16:
        return bytes(u)
    if isinstance(u, str):
        return _uuid.UUID(u).bytes
    raise EncodeError(f"not a uuid: {u!r}")


def uuid_from_wire(b: bytes) -> _uuid.UUID:
    return _uuid.UUID(bytes=bytes(b))


# --------------------------------------------------------------------------
# Schema type nodes
# --------------------------------------------------------------------------


class Type:
    """Base class for wire types."""

    # Static wire width in bytes, or None if dynamic.
    def static_size(self) -> Optional[int]:
        raise NotImplementedError

    def __repr__(self):
        return self.type_name()

    def type_name(self) -> str:
        raise NotImplementedError


class Prim(Type):
    __slots__ = ("name", "size", "np_dtype", "fmt")

    def __init__(self, name: str):
        name = ALIASES.get(name, name)
        if name not in _PRIM_SPECS:
            raise SchemaError(f"unknown primitive: {name}")
        self.name = name
        self.size, self.np_dtype, self.fmt = _PRIM_SPECS[name]

    def static_size(self):
        return self.size

    def type_name(self):
        return self.name

    def __eq__(self, other):
        return isinstance(other, Prim) and other.name == self.name

    def __hash__(self):
        return hash(("prim", self.name))


# Pre-made singletons for convenience.
BOOL = Prim("bool")
BYTE = Prim("byte")
UINT8 = Prim("uint8")
INT8 = Prim("int8")
INT16 = Prim("int16")
UINT16 = Prim("uint16")
INT32 = Prim("int32")
UINT32 = Prim("uint32")
INT64 = Prim("int64")
UINT64 = Prim("uint64")
FLOAT16 = Prim("float16")
BFLOAT16 = Prim("bfloat16")
FLOAT32 = Prim("float32")
FLOAT64 = Prim("float64")
INT128 = Prim("int128")
UINT128 = Prim("uint128")
UUID = Prim("uuid")
TIMESTAMP = Prim("timestamp")
DURATION = Prim("duration")


class StringT(Type):
    def static_size(self):
        return None

    def type_name(self):
        return "string"

    def __eq__(self, other):
        return isinstance(other, StringT)

    def __hash__(self):
        return hash("string")


STRING = StringT()


class Array(Type):
    """Dynamic array: u32 count prefix + elements (§3.6)."""

    __slots__ = ("elem",)

    def __init__(self, elem: Type):
        self.elem = elem

    def static_size(self):
        return None

    def type_name(self):
        return f"{self.elem.type_name()}[]"

    def __eq__(self, other):
        return isinstance(other, Array) and not isinstance(other, FixedArray) \
            and other.elem == self.elem

    def __hash__(self):
        return hash(("array", self.elem))


class FixedArray(Array):
    """Fixed array: no prefix, compile-time element count (§3.6)."""

    __slots__ = ("elem", "count")

    def __init__(self, elem: Type, count: int):
        if not (0 <= count <= MAX_FIXED_ARRAY):
            raise SchemaError(f"fixed array size out of range: {count}")
        super().__init__(elem)
        self.count = count

    def static_size(self):
        es = self.elem.static_size()
        return None if es is None else es * self.count

    def type_name(self):
        return f"{self.elem.type_name()}[{self.count}]"

    def __eq__(self, other):
        return (isinstance(other, FixedArray) and other.elem == self.elem
                and other.count == self.count)

    def __hash__(self):
        return hash(("fixed_array", self.elem, self.count))


class MapT(Type):
    """Map: u32 count prefix + key/value pairs (§3.7)."""

    __slots__ = ("key", "value")

    def __init__(self, key: Type, value: Type):
        if not (isinstance(key, Prim) and key.name in VALID_MAP_KEY_PRIMS) \
                and not isinstance(key, (StringT, Enum)):
            raise SchemaError(
                f"invalid map key type {key.type_name()} "
                "(floats excluded: NaN / signed-zero equality)")
        self.key = key
        self.value = value

    def static_size(self):
        return None

    def type_name(self):
        return f"map[{self.key.type_name()}, {self.value.type_name()}]"

    def __eq__(self, other):
        return isinstance(other, MapT) and other.key == self.key \
            and other.value == self.value

    def __hash__(self):
        return hash(("map", self.key, self.value))


@dataclasses.dataclass
class Field:
    name: str
    type: Type
    tag: Optional[int] = None       # messages only, 1..255
    doc: str = ""
    deprecated: bool = False
    decorators: List["DecoratorUsage"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DecoratorUsage:
    name: str
    args: Dict[str, object] = dataclasses.field(default_factory=dict)
    exported: Optional[Dict[str, object]] = None  # from the export block


class _Named(Type):
    name: str

    def type_name(self):
        return self.name


class Struct(_Named):
    """Positional encoding, no tags, no length prefix (§3.8)."""

    def __init__(self, name: str, fields: Sequence[Field], *,
                 mutable: bool = False, doc: str = "",
                 visibility: str = "export",
                 decorators: Optional[List[DecoratorUsage]] = None):
        self.name = name
        self.fields = list(fields)
        self.mutable = mutable
        self.doc = doc
        self.visibility = visibility
        self.decorators = decorators or []
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

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)


class Message(_Named):
    """Tagged fields behind a u32 length prefix, 0x00 end marker (§3.9)."""

    def __init__(self, name: str, fields: Sequence[Field], *, doc: str = "",
                 visibility: str = "export",
                 decorators: Optional[List[DecoratorUsage]] = None):
        self.name = name
        self.fields = list(fields)
        self.doc = doc
        self.visibility = visibility
        self.decorators = decorators or []
        tags = set()
        for f in self.fields:
            if f.tag is None:
                raise SchemaError(f"message field {name}.{f.name} missing tag")
            if not (1 <= f.tag <= MAX_TAG):
                raise SchemaError(f"tag out of range 1-255: {f.tag}")
            if f.tag in tags:
                raise SchemaError(f"duplicate tag {f.tag} in message {name}")
            tags.add(f.tag)

    def static_size(self):
        return None

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def field_by_tag(self, tag: int) -> Optional[Field]:
        for f in self.fields:
            if f.tag == tag:
                return f
        return None


@dataclasses.dataclass
class Branch:
    name: str
    discriminator: int
    type: Type
    doc: str = ""


class Union(_Named):
    """u32 length prefix + 1-byte discriminator + branch content (§3.10)."""

    def __init__(self, name: str, branches: Sequence[Branch], *, doc: str = "",
                 visibility: str = "export",
                 decorators: Optional[List[DecoratorUsage]] = None):
        self.name = name
        self.branches = list(branches)
        self.doc = doc
        self.visibility = visibility
        self.decorators = decorators or []
        seen = set()
        for b in self.branches:
            if not (0 <= b.discriminator <= MAX_DISCRIMINATOR):
                raise SchemaError(
                    f"discriminator out of range 0-255: {b.discriminator}")
            if b.discriminator in seen:
                raise SchemaError(
                    f"duplicate discriminator {b.discriminator} in union {name}")
            seen.add(b.discriminator)

    def static_size(self):
        return None

    def branch(self, name: str) -> Branch:
        for b in self.branches:
            if b.name == name:
                return b
        raise KeyError(name)

    def branch_by_discriminator(self, d: int) -> Optional[Branch]:
        for b in self.branches:
            if b.discriminator == d:
                return b
        return None


@dataclasses.dataclass(frozen=True)
class UnionValue:
    """Decoded union: discriminator + branch name + inner value."""

    discriminator: int
    name: str
    value: object


class Enum(_Named):
    """Named integer constants over an underlying int type (§5.6)."""

    def __init__(self, name: str, members: Dict[str, int], *,
                 base: Prim = UINT32, doc: str = "",
                 visibility: str = "export",
                 decorators: Optional[List[DecoratorUsage]] = None):
        if base.name not in INTEGER_PRIMS:
            raise SchemaError(f"enum base must be integer, got {base.name}")
        if 0 not in members.values():
            raise SchemaError(f"enum {name} must have a member with value 0")
        self.name = name
        self.members = dict(members)
        self.base = base
        self.doc = doc
        self.visibility = visibility
        self.decorators = decorators or []
        lo, hi = _INT_RANGES[base.name]
        for m, v in members.items():
            if not (lo <= v <= hi):
                raise SchemaError(f"enum member {name}.{m}={v} out of "
                                  f"{base.name} range")

    def static_size(self):
        return self.base.size

    def name_of(self, value: int) -> Optional[str]:
        for m, v in self.members.items():
            if v == value:
                return m
        return None


def check_int_range(prim_name: str, v: int) -> None:
    lo, hi = _INT_RANGES[prim_name]
    if not (lo <= v <= hi):
        raise EncodeError(f"{prim_name} out of range: {v}")


def is_struct_fixed(t: Type) -> bool:
    return t.static_size() is not None
