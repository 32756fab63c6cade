"""Reference Bebop encoder/decoder (paper §3).

Copied unchanged from the JAX package's ``core/wire.py``: it is JAX-free
host code, and both packages must put the same bytes on the wire.

This is the bounds-checked, value-at-a-time codec — the semantic oracle the
fast paths (``fastwire``, ``codegen``, the Pallas device kernels) are tested
against.  Every multi-byte value is little-endian.  Decode never reads past
``len(buf)``; any overrun raises :class:`DecodeError`.

Value model:
  * primitives -> python int / float / bool
  * bfloat16   -> python float (lossy round-trip by construction)
  * uuid       -> ``uuid.UUID``
  * timestamp / duration -> :class:`types.Timestamp` / :class:`types.Duration`
  * string     -> ``str``
  * arrays     -> list, or numpy array for numeric element types
  * map        -> dict
  * struct / message -> dict keyed by field name (absent message fields
    simply missing from the dict — "not set" is distinguishable from default)
  * union      -> :class:`types.UnionValue`
  * enum       -> int
"""
from __future__ import annotations

import struct as _struct
from typing import Any, Optional, Tuple

import numpy as np

from . import types as T

_U32 = _struct.Struct("<I")
_I32 = _struct.Struct("<i")
_I64 = _struct.Struct("<q")


class Writer:
    """Append-only byte sink."""

    __slots__ = ("_chunks", "_size")

    def __init__(self):
        self._chunks = []
        self._size = 0

    def write(self, b: bytes) -> None:
        self._chunks.append(b)
        self._size += len(b)

    def u8(self, v: int) -> None:
        self.write(bytes((v & 0xFF,)))

    def u32(self, v: int) -> None:
        self.write(_U32.pack(v))

    def size(self) -> int:
        return self._size

    def getvalue(self) -> bytes:
        return b"".join(self._chunks)


class Reader:
    """Bounds-checked cursor over an input buffer."""

    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf, pos: int = 0, end: Optional[int] = None):
        self.buf = memoryview(buf)
        self.pos = pos
        self.end = len(self.buf) if end is None else end
        if self.end > len(self.buf):
            raise T.DecodeError("reader window beyond buffer")

    def need(self, n: int) -> None:
        if self.pos + n > self.end:
            raise T.DecodeError(
                f"decode overrun: need {n} bytes at {self.pos}, end {self.end}")

    def take(self, n: int) -> memoryview:
        self.need(n)
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        self.need(1)
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------


def encode(t: T.Type, value: Any) -> bytes:
    w = Writer()
    _encode(t, value, w)
    return w.getvalue()


def _encode(t: T.Type, value: Any, w: Writer) -> None:
    if isinstance(t, T.Enum):
        _encode_prim(t.base, int(value), w)
    elif isinstance(t, T.Prim):
        _encode_prim(t, value, w)
    elif isinstance(t, T.StringT):
        _encode_string(value, w)
    elif isinstance(t, T.FixedArray):
        _encode_fixed_array(t, value, w)
    elif isinstance(t, T.Array):
        _encode_array(t, value, w)
    elif isinstance(t, T.MapT):
        _encode_map(t, value, w)
    elif isinstance(t, T.Struct):
        _encode_struct(t, value, w)
    elif isinstance(t, T.Message):
        _encode_message(t, value, w)
    elif isinstance(t, T.Union):
        _encode_union(t, value, w)
    else:
        raise T.EncodeError(f"cannot encode type {t!r}")


def _encode_prim(t: T.Prim, value: Any, w: Writer) -> None:
    n = t.name
    if n == "bool":
        w.u8(1 if value else 0)
    elif n in ("byte", "uint8", "int8", "int16", "uint16", "int32", "uint32",
               "int64", "uint64"):
        T.check_int_range(n, int(value))
        w.write(_struct.pack(t.fmt, int(value)))
    elif n in ("float32", "float64", "float16"):
        w.write(_struct.pack(t.fmt, float(value)))
    elif n == "bfloat16":
        w.write(_struct.pack("<H", T.encode_bf16(float(value))))
    elif n == "int128":
        w.write(T.encode_int128(int(value), signed=True))
    elif n == "uint128":
        w.write(T.encode_int128(int(value), signed=False))
    elif n == "uuid":
        w.write(T.uuid_to_wire(value))
    elif n == "timestamp":
        ts = value
        w.write(_I64.pack(ts.sec))
        w.write(_I32.pack(ts.ns))
        w.write(_I32.pack(ts.offset_ms))
    elif n == "duration":
        d = value
        w.write(_I64.pack(d.sec))
        w.write(_I32.pack(d.ns))
    else:  # pragma: no cover
        raise T.EncodeError(f"unhandled primitive {n}")


def _encode_string(value: str, w: Writer) -> None:
    if isinstance(value, bytes):
        data = value
    else:
        data = str(value).encode("utf-8")
    w.u32(len(data))
    w.write(data)
    w.u8(0)  # NUL terminator enables zero-copy C-string views (§3.5)


def _elements_bytes(elem: T.Type, values) -> Optional[bytes]:
    """Vectorized bulk encode for numeric element types; None if unsupported."""
    if not isinstance(elem, T.Prim) or elem.np_dtype is None:
        return None
    if isinstance(values, (bytes, bytearray, memoryview)):
        if elem.size != 1:
            values = np.frombuffer(values, dtype=elem.np_dtype)
        else:
            return bytes(values)
    if elem.name == "bfloat16":
        arr = np.asarray(values)
        if arr.dtype == np.dtype("<u2") and not np.issubdtype(arr.dtype, np.floating):
            # already raw bits
            return np.ascontiguousarray(arr, dtype="<u2").tobytes()
        return T.f32_array_to_bf16(np.asarray(values, dtype="<f4")).tobytes()
    if elem.name == "bool":
        return np.asarray(values, dtype="u1").clip(0, 1).tobytes()
    return np.ascontiguousarray(np.asarray(values), dtype=elem.np_dtype).tobytes()


def _encode_array(t: T.Array, value, w: Writer) -> None:
    n = len(value)
    w.u32(n)
    bulk = _elements_bytes(t.elem, value)
    if bulk is not None:
        w.write(bulk)
        return
    for v in value:
        _encode(t.elem, v, w)


def _encode_fixed_array(t: T.FixedArray, value, w: Writer) -> None:
    if len(value) != t.count:
        raise T.EncodeError(
            f"fixed array expects {t.count} elements, got {len(value)}")
    bulk = _elements_bytes(t.elem, value)
    if bulk is not None:
        w.write(bulk)
        return
    for v in value:
        _encode(t.elem, v, w)


def _encode_map(t: T.MapT, value: dict, w: Writer) -> None:
    w.u32(len(value))
    for k, v in value.items():
        _encode(t.key, k, w)
        _encode(t.value, v, w)


def _encode_struct(t: T.Struct, value: dict, w: Writer) -> None:
    for f in t.fields:
        if f.name not in value:
            raise T.EncodeError(f"struct {t.name} missing field {f.name}")
        _encode(f.type, value[f.name], w)


def _encode_message(t: T.Message, value: dict, w: Writer) -> None:
    body = Writer()
    for f in t.fields:
        if f.name not in value:
            continue  # absent fields are not encoded (§3.9)
        body.u8(f.tag)
        _encode(f.type, value[f.name], body)
    body.u8(0)  # end marker
    payload = body.getvalue()
    w.u32(len(payload))
    w.write(payload)


def _encode_union(t: T.Union, value, w: Writer) -> None:
    if isinstance(value, T.UnionValue):
        branch = t.branch(value.name)
        inner = value.value
    elif isinstance(value, tuple) and len(value) == 2:
        branch = t.branch(value[0])
        inner = value[1]
    else:
        raise T.EncodeError(f"union value must be UnionValue or (name, value)")
    body = Writer()
    _encode(branch.type, inner, body)
    payload = body.getvalue()
    w.u32(1 + len(payload))
    w.u8(branch.discriminator)
    w.write(payload)


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------


def decode(t: T.Type, buf, *, offset: int = 0) -> Any:
    r = Reader(buf, offset)
    return _decode(t, r)


def decode_with_end(t: T.Type, buf, *, offset: int = 0) -> Tuple[Any, int]:
    r = Reader(buf, offset)
    v = _decode(t, r)
    return v, r.pos


def _decode(t: T.Type, r: Reader) -> Any:
    if isinstance(t, T.Enum):
        return _decode_prim(t.base, r)
    if isinstance(t, T.Prim):
        return _decode_prim(t, r)
    if isinstance(t, T.StringT):
        return _decode_string(r)
    if isinstance(t, T.FixedArray):
        return _decode_fixed_array(t, r)
    if isinstance(t, T.Array):
        return _decode_array(t, r)
    if isinstance(t, T.MapT):
        return _decode_map(t, r)
    if isinstance(t, T.Struct):
        return _decode_struct(t, r)
    if isinstance(t, T.Message):
        return _decode_message(t, r)
    if isinstance(t, T.Union):
        return _decode_union(t, r)
    raise T.DecodeError(f"cannot decode type {t!r}")


def _decode_prim(t: T.Prim, r: Reader) -> Any:
    n = t.name
    if n == "bool":
        return r.u8() != 0
    if t.fmt is not None:
        return _struct.unpack(t.fmt, r.take(t.size))[0]
    if n == "bfloat16":
        return T.decode_bf16(_struct.unpack("<H", r.take(2))[0])
    if n == "int128":
        return T.decode_int128(bytes(r.take(16)), signed=True)
    if n == "uint128":
        return T.decode_int128(bytes(r.take(16)), signed=False)
    if n == "uuid":
        return T.uuid_from_wire(r.take(16))
    if n == "timestamp":
        sec = _I64.unpack(r.take(8))[0]
        ns = _I32.unpack(r.take(4))[0]
        off = _I32.unpack(r.take(4))[0]
        return T.Timestamp(sec, ns, off)
    if n == "duration":
        sec = _I64.unpack(r.take(8))[0]
        ns = _I32.unpack(r.take(4))[0]
        return T.Duration(sec, ns)
    raise T.DecodeError(f"unhandled primitive {n}")  # pragma: no cover


def _decode_string(r: Reader) -> str:
    n = r.u32()
    data = bytes(r.take(n))
    nul = r.u8()
    if nul != 0:
        raise T.DecodeError("string missing NUL terminator")
    return data.decode("utf-8")


def _bulk_decode(elem: T.Type, count: int, r: Reader):
    """Vectorized element decode; None if element type unsupported."""
    if not isinstance(elem, T.Prim) or elem.np_dtype is None:
        return None
    raw = r.take(count * elem.size)
    arr = np.frombuffer(raw, dtype=elem.np_dtype)
    if elem.name == "bfloat16":
        return T.bf16_array_to_f32(arr)
    if elem.name == "bool":
        return arr != 0
    return arr


def _decode_array(t: T.Array, r: Reader):
    n = r.u32()
    bulk = _bulk_decode(t.elem, n, r)
    if bulk is not None:
        return bulk
    return [_decode(t.elem, r) for _ in range(n)]


def _decode_fixed_array(t: T.FixedArray, r: Reader):
    bulk = _bulk_decode(t.elem, t.count, r)
    if bulk is not None:
        return bulk
    return [_decode(t.elem, r) for _ in range(t.count)]


def _decode_map(t: T.MapT, r: Reader) -> dict:
    n = r.u32()
    out = {}
    for _ in range(n):
        k = _decode(t.key, r)
        v = _decode(t.value, r)
        out[k] = v
    return out


def _decode_struct(t: T.Struct, r: Reader) -> dict:
    return {f.name: _decode(f.type, r) for f in t.fields}


def _decode_message(t: T.Message, r: Reader) -> dict:
    length = r.u32()
    end = r.pos + length
    if end > r.end:
        raise T.DecodeError("message length beyond buffer")
    out = {}
    sub = Reader(r.buf, r.pos, end)
    while True:
        tag = sub.u8()
        if tag == 0:
            break
        f = t.field_by_tag(tag)
        if f is None:
            # Unknown tags are skipped by decoders (§3.9).  Unknown fields in
            # a *message* require a skippable encoding; every Bebop value is
            # either fixed-width or length-prefixed EXCEPT bare structs, so a
            # well-formed evolved message only adds self-delimiting fields.
            # Without the field's schema we cannot know its width; the spec's
            # evolution rules (Table 9) guarantee old readers only meet
            # unknown tags from *newer* writers of the same lineage, which we
            # resolve by skipping to the message end on first unknown tag if
            # no skip table is present.
            skip = _skip_table(t).get(tag)
            if skip is None:
                sub.pos = end
                break
            skip(sub)
            continue
        out[f.name] = _decode(f.type, sub)
    r.pos = end
    return out


def _skip_table(t: T.Message):
    # Messages may carry a registry of retired tags -> skip functions so
    # old readers can hop over deprecated fields without full schema info.
    return getattr(t, "retired_tag_skippers", {})


def _decode_union(t: T.Union, r: Reader) -> T.UnionValue:
    length = r.u32()
    end = r.pos + length
    if end > r.end:
        raise T.DecodeError("union length beyond buffer")
    disc = r.u8()
    b = t.branch_by_discriminator(disc)
    if b is None:
        raise T.DecodeError(f"unknown union discriminator {disc} in {t.name}")
    sub = Reader(r.buf, r.pos, end)
    v = _decode(b.type, sub)
    r.pos = end
    return T.UnionValue(disc, b.name, v)


def encoded_size(t: T.Type, value: Any) -> int:
    """Wire size of ``value`` under ``t`` (used by Table 8 benchmarks)."""
    return len(encode(t, value))
