"""Protocol-Buffers-style varint codec — the paper's baseline, implemented.

Faithful to the protobuf wire format (so the comparison is honest):

  * field keys: ``(field_number << 3) | wire_type`` — themselves varints
  * wire types: 0=varint, 1=64-bit, 2=length-delimited, 5=32-bit
  * base-128 varints with continuation bit — the branch-per-byte decode loop
    the paper measures against
  * negative int32/int64 sign-extend to 10 bytes (§2.1.3's pathological case)
  * packed repeated scalars: length-delimited, element-at-a-time decode
  * strings / bytes / submessages: length-delimited
  * uuid: canonical 36-char ASCII string (paper Fig. 2 — protobuf has no
    native uuid, which costs 20 bytes vs Bebop)
  * bfloat16/float16 arrays: a ``bytes`` field of raw 2-byte values (Fig. 2)
  * timestamp/duration: google.protobuf-style submessages {1: sec, 2: ns}
  * Bebop unions -> oneof-style: submessage keyed by discriminator
  * maps: repeated {1: key, 2: value} submessages

Schema mapping: Bebop struct fields take field numbers 1..N in order; Bebop
message fields keep their Bebop tags as protobuf field numbers.

Copied unchanged from the JAX package's ``core/varint.py``.
"""
from __future__ import annotations

import struct as _struct
from typing import Any, Tuple

import numpy as np

from . import types as T

WT_VARINT = 0
WT_64 = 1
WT_LEN = 2
WT_32 = 5


# --------------------------------------------------------------------------
# Varint primitives
# --------------------------------------------------------------------------


def write_uvarint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_uvarint(buf, pos: int) -> Tuple[int, int]:
    """The branch-per-byte loop (paper §2.1)."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise T.DecodeError("varint overruns buffer")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise T.DecodeError("varint too long")


def read_packed_uvarints(body) -> list:
    """Vectorized decode of a packed varint run (numpy continuation scan).

    Byte-exact with looping :func:`read_uvarint` over ``body``: same
    values, same error cases.  Instead of a branch per byte, one pass over
    the buffer classifies continuation bits, a ``reduceat`` ORs each
    group's 7-bit payloads into place, and only the (protobuf-invalid)
    >64-bit stragglers fall back to the scalar loop.  This keeps the
    protobuf *baseline* honest in the paper comparison: the fixed-layout
    side keeps getting faster, so the varint side gets the best
    vectorization its format admits.
    """
    arr = np.frombuffer(bytes(body), dtype=np.uint8)
    if arr.size == 0:
        return []
    cont = (arr & 0x80) != 0
    if cont[-1]:
        raise T.DecodeError("varint overruns buffer")
    ends = np.flatnonzero(~cont)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lengths = ends - starts + 1
    if int(lengths.max()) > 10:
        raise T.DecodeError("varint too long")
    if int(lengths.max()) == 10:
        # 10-byte varints whose top byte exceeds 1 overflow 64 bits; the
        # scalar loop's Python ints keep the extra bits, so defer to it
        # for byte-exactness on that (protobuf-invalid) corner
        if (arr[ends[lengths == 10]] > 1).any():
            raw = arr.tobytes()  # scalar loop needs Python ints, not uint8
            out, pos = [], 0
            while pos < len(raw):
                v, pos = read_uvarint(raw, pos)
                out.append(v)
            return out
    shift = (7 * (np.arange(arr.size) - np.repeat(starts, lengths))
             ).astype(np.uint64)
    vals = (arr & 0x7F).astype(np.uint64) << shift
    return np.bitwise_or.reduceat(vals, starts).tolist()


def uvarint_size(v: int) -> int:
    n = 1
    while v >= 0x80:
        v >>= 7
        n += 1
    return n


def zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _int_as_uint64(v: int) -> int:
    """protobuf int32/int64 semantics: negatives sign-extend to 64 bits."""
    return v & 0xFFFFFFFFFFFFFFFF


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------


def encode(t: T.Type, value: Any) -> bytes:
    out = bytearray()
    if isinstance(t, (T.Struct, T.Message)):
        _encode_fields(t, value, out)
    elif isinstance(t, T.Union):
        _encode_union_body(t, value, out)
    else:
        # bare scalar: encode as field 1 of an implicit message
        _encode_field(1, t, value, out)
    return bytes(out)


def _field_numbers(t) -> dict:
    if isinstance(t, T.Message):
        return {f.name: f.tag for f in t.fields}
    return {f.name: i + 1 for i, f in enumerate(t.fields)}


def _encode_fields(t, value: dict, out: bytearray) -> None:
    nums = _field_numbers(t)
    for f in t.fields:
        if isinstance(t, T.Message) and f.name not in value:
            continue
        _encode_field(nums[f.name], f.type, value[f.name], out)


def _key(out: bytearray, num: int, wt: int) -> None:
    write_uvarint(out, (num << 3) | wt)


def _encode_field(num: int, ft: T.Type, v: Any, out: bytearray) -> None:
    if isinstance(ft, T.Enum):
        _key(out, num, WT_VARINT)
        write_uvarint(out, _int_as_uint64(int(v)))
    elif isinstance(ft, T.Prim):
        _encode_prim_field(num, ft, v, out)
    elif isinstance(ft, T.StringT):
        _key(out, num, WT_LEN)
        data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        write_uvarint(out, len(data))
        out += data
    elif isinstance(ft, T.Array):
        _encode_repeated(num, ft, v, out)
    elif isinstance(ft, T.MapT):
        for k, val in v.items():
            body = bytearray()
            _encode_field(1, ft.key, k, body)
            _encode_field(2, ft.value, val, body)
            _key(out, num, WT_LEN)
            write_uvarint(out, len(body))
            out += body
    elif isinstance(ft, (T.Struct, T.Message)):
        body = bytearray()
        _encode_fields(ft, v, body)
        _key(out, num, WT_LEN)
        write_uvarint(out, len(body))
        out += body
    elif isinstance(ft, T.Union):
        body = bytearray()
        _encode_union_body(ft, v, body)
        _key(out, num, WT_LEN)
        write_uvarint(out, len(body))
        out += body
    else:
        raise T.EncodeError(f"varint codec cannot encode {ft!r}")


def _encode_union_body(ft: T.Union, v, out: bytearray) -> None:
    if isinstance(v, T.UnionValue):
        branch, inner = ft.branch(v.name), v.value
    else:
        branch, inner = ft.branch(v[0]), v[1]
    _encode_field(branch.discriminator, branch.type, inner, out)


def _encode_prim_field(num: int, ft: T.Prim, v: Any, out: bytearray) -> None:
    n = ft.name
    if n in ("bool",):
        _key(out, num, WT_VARINT)
        write_uvarint(out, 1 if v else 0)
    elif n in ("byte", "uint8", "uint16", "uint32", "uint64"):
        _key(out, num, WT_VARINT)
        write_uvarint(out, int(v))
    elif n in ("int8", "int16", "int32", "int64"):
        # protobuf int32/int64: negatives cost 10 bytes (§2.1.3)
        _key(out, num, WT_VARINT)
        write_uvarint(out, _int_as_uint64(int(v)))
    elif n == "float32":
        _key(out, num, WT_32)
        out += _struct.pack("<f", float(v))
    elif n == "float64":
        _key(out, num, WT_64)
        out += _struct.pack("<d", float(v))
    elif n in ("float16", "bfloat16"):
        # no protobuf equivalent; 2-byte bytes field (Fig. 2 convention)
        _key(out, num, WT_LEN)
        raw = (T.encode_bf16(float(v)) if n == "bfloat16"
               else _struct.unpack("<H", _struct.pack("<e", float(v)))[0])
        write_uvarint(out, 2)
        out += _struct.pack("<H", raw)
    elif n in ("int128", "uint128"):
        _key(out, num, WT_LEN)
        write_uvarint(out, 16)
        out += T.encode_int128(int(v), signed=(n == "int128"))
    elif n == "uuid":
        # canonical 36-char ASCII string (Fig. 2)
        s = str(T.uuid_from_wire(T.uuid_to_wire(v)))
        data = s.encode("ascii")
        _key(out, num, WT_LEN)
        write_uvarint(out, len(data))
        out += data
    elif n == "timestamp":
        body = bytearray()
        if v.sec:
            _key(body, 1, WT_VARINT)
            write_uvarint(body, _int_as_uint64(v.sec))
        if v.ns:
            _key(body, 2, WT_VARINT)
            write_uvarint(body, _int_as_uint64(v.ns))
        if v.offset_ms:
            _key(body, 3, WT_VARINT)
            write_uvarint(body, _int_as_uint64(v.offset_ms))
        _key(out, num, WT_LEN)
        write_uvarint(out, len(body))
        out += body
    elif n == "duration":
        body = bytearray()
        if v.sec:
            _key(body, 1, WT_VARINT)
            write_uvarint(body, _int_as_uint64(v.sec))
        if v.ns:
            _key(body, 2, WT_VARINT)
            write_uvarint(body, _int_as_uint64(v.ns))
        _key(out, num, WT_LEN)
        write_uvarint(out, len(body))
        out += body
    else:
        raise T.EncodeError(f"unhandled primitive {n}")


_PACKED_FIXED = {"float32": ("<f", WT_32, 4), "float64": ("<d", WT_64, 8)}
_PACKED_VARINT = {"bool", "byte", "uint8", "uint16", "uint32", "uint64",
                  "int8", "int16", "int32", "int64"}


def _encode_repeated(num: int, ft: T.Array, values, out: bytearray) -> None:
    elem = ft.elem
    if isinstance(elem, T.Prim) and elem.name in ("byte", "uint8"):
        # bytes field
        if isinstance(values, (bytes, bytearray, memoryview)):
            data = bytes(values)
        else:
            data = np.asarray(values).astype("u1").tobytes()
        _key(out, num, WT_LEN)
        write_uvarint(out, len(data))
        out += data
        return
    if isinstance(elem, T.Prim) and elem.name in ("bfloat16", "float16"):
        # packed raw 2-byte values as a bytes field (Fig. 2 convention)
        arr = np.asarray(values)
        if arr.dtype.kind == "f":
            raw = (T.f32_array_to_bf16(arr.astype("<f4"))
                   if elem.name == "bfloat16" else arr.astype("<f2").view("<u2"))
        else:
            raw = arr.astype("<u2")
        data = raw.tobytes()
        _key(out, num, WT_LEN)
        write_uvarint(out, len(data))
        out += data
        return
    if isinstance(elem, T.Prim) and elem.name in _PACKED_FIXED:
        fmt, _, size = _PACKED_FIXED[elem.name]
        body = bytearray()
        for v in np.asarray(values, dtype="f8").tolist():
            body += _struct.pack(fmt, v)
        _key(out, num, WT_LEN)
        write_uvarint(out, len(body))
        out += body
        return
    if (isinstance(elem, T.Prim) and elem.name in _PACKED_VARINT) \
            or isinstance(elem, T.Enum):
        body = bytearray()
        vals = values.tolist() if isinstance(values, np.ndarray) else values
        for v in vals:
            write_uvarint(body, _int_as_uint64(int(v)))
        _key(out, num, WT_LEN)
        write_uvarint(out, len(body))
        out += body
        return
    # non-packed: one length-delimited entry per element
    for v in values:
        _encode_field(num, elem, v, out)


# --------------------------------------------------------------------------
# Decode — every scalar pays the branch-per-byte loop
# --------------------------------------------------------------------------


def decode(t: T.Type, buf) -> Any:
    buf = bytes(buf)
    if isinstance(t, (T.Struct, T.Message)):
        return _decode_fields(t, buf, 0, len(buf))
    if isinstance(t, T.Union):
        return _decode_union_body(t, buf, 0, len(buf))
    fields = _decode_raw(buf, 0, len(buf))
    return _coerce(t, fields[1][0]) if 1 in fields else None


def _decode_raw(buf, pos, end):
    """Parse the tag/value stream into {field_number: [raw values]}."""
    out: dict = {}
    while pos < end:
        key, pos = read_uvarint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == WT_VARINT:
            v, pos = read_uvarint(buf, pos)
        elif wt == WT_64:
            v = buf[pos:pos + 8]
            pos += 8
        elif wt == WT_32:
            v = buf[pos:pos + 4]
            pos += 4
        elif wt == WT_LEN:
            ln, pos = read_uvarint(buf, pos)
            if pos + ln > end:
                raise T.DecodeError("length-delimited field overruns")
            v = buf[pos:pos + ln]
            pos += ln
        else:
            raise T.DecodeError(f"bad wire type {wt}")
        out.setdefault(num, []).append((v, wt))
    return {k: tuple(x[0] for x in v) if False else v for k, v in out.items()}


def _decode_fields(t, buf, pos, end) -> dict:
    raw = _decode_raw(buf, pos, end)
    nums = _field_numbers(t)
    out = {}
    for f in t.fields:
        num = nums[f.name]
        if num not in raw:
            if isinstance(t, T.Struct):
                out[f.name] = _default(f.type)
            continue
        out[f.name] = _coerce_field(f.type, raw[num])
    return out


def _decode_union_body(t: T.Union, buf, pos, end):
    raw = _decode_raw(buf, pos, end)
    for b in t.branches:
        if b.discriminator in raw:
            return T.UnionValue(b.discriminator, b.name,
                                _coerce_field(b.type, raw[b.discriminator]))
    raise T.DecodeError("union with no known branch")


def _sign64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _coerce_field(ft: T.Type, raws):
    if isinstance(ft, T.Array):
        return _coerce_repeated(ft, raws)
    if isinstance(ft, T.MapT):
        out = {}
        for body, _wt in raws:
            kv = _decode_raw(body, 0, len(body))
            k = _coerce(ft.key, kv[1][0]) if 1 in kv else _default(ft.key)
            v = _coerce(ft.value, kv[2][0]) if 2 in kv else _default(ft.value)
            out[k] = v
        return out
    return _coerce(ft, raws[-1])  # last-one-wins, protobuf semantics


def _coerce(ft: T.Type, raw):
    v, wt = raw
    if isinstance(ft, T.Enum):
        return _sign64(v) if isinstance(v, int) else v
    if isinstance(ft, (T.Struct, T.Message)):
        return _decode_fields(ft, v, 0, len(v))
    if isinstance(ft, T.Union):
        return _decode_union_body(ft, v, 0, len(v))
    if isinstance(ft, T.StringT):
        return bytes(v).decode("utf-8")
    assert isinstance(ft, T.Prim)
    n = ft.name
    if n == "bool":
        return bool(v)
    if n in ("byte", "uint8", "uint16", "uint32", "uint64"):
        return int(v)
    if n in ("int8", "int16", "int32", "int64"):
        return _sign64(int(v))
    if n == "float32":
        return _struct.unpack("<f", bytes(v))[0]
    if n == "float64":
        return _struct.unpack("<d", bytes(v))[0]
    if n == "float16":
        return _struct.unpack("<e", bytes(v))[0]
    if n == "bfloat16":
        return T.decode_bf16(_struct.unpack("<H", bytes(v))[0])
    if n in ("int128", "uint128"):
        return T.decode_int128(bytes(v), signed=(n == "int128"))
    if n == "uuid":
        import uuid as _uuid
        return _uuid.UUID(bytes(v).decode("ascii"))
    if n == "timestamp":
        kv = _decode_raw(v, 0, len(v))
        return T.Timestamp(
            _sign64(kv[1][0][0]) if 1 in kv else 0,
            _sign64(kv[2][0][0]) if 2 in kv else 0,
            _sign64(kv[3][0][0]) if 3 in kv else 0)
    if n == "duration":
        kv = _decode_raw(v, 0, len(v))
        return T.Duration(_sign64(kv[1][0][0]) if 1 in kv else 0,
                          _sign64(kv[2][0][0]) if 2 in kv else 0)
    raise T.DecodeError(f"unhandled primitive {n}")


def _coerce_repeated(ft: T.Array, raws):
    elem = ft.elem
    if isinstance(elem, T.Prim) and elem.name in ("byte", "uint8"):
        body, _ = raws[-1]
        return np.frombuffer(bytes(body), dtype="u1")
    if isinstance(elem, T.Prim) and elem.name in ("bfloat16", "float16"):
        body, _ = raws[-1]
        raw = np.frombuffer(bytes(body), dtype="<u2")
        return (T.bf16_array_to_f32(raw) if elem.name == "bfloat16"
                else raw.view("<f2").astype("<f4"))
    if isinstance(elem, T.Prim) and elem.name in _PACKED_FIXED:
        fmt, _, size = _PACKED_FIXED[elem.name]
        body, wt = raws[-1]
        if wt == WT_LEN:
            # element-at-a-time, mirroring protobuf-c repeated field decode
            out = []
            for off in range(0, len(body), size):
                out.append(_struct.unpack_from(fmt, body, off)[0])
            return out
        return [_struct.unpack(fmt, bytes(r))[0] for r, _ in raws]
    if (isinstance(elem, T.Prim) and elem.name in _PACKED_VARINT) \
            or isinstance(elem, T.Enum):
        signed = isinstance(elem, T.Enum) or elem.name.startswith("int")
        out = []
        for body, wt in raws:
            if wt == WT_LEN:
                # vectorized continuation-bit scan (byte-exact with the
                # element-at-a-time loop it replaced)
                vs = read_packed_uvarints(body)
                out.extend(_sign64(v) if signed else v for v in vs)
            else:
                out.append(_sign64(body) if signed else body)
        if isinstance(elem, T.Prim) and elem.name == "bool":
            return [bool(x) for x in out]
        return out
    # non-packed structured elements
    return [_coerce(elem, r) for r in raws]


def _default(ft: T.Type):
    if isinstance(ft, T.Enum):
        return 0
    if isinstance(ft, T.StringT):
        return ""
    if isinstance(ft, T.Array):
        return []
    if isinstance(ft, T.MapT):
        return {}
    if isinstance(ft, (T.Struct,)):
        return {f.name: _default(f.type) for f in ft.fields}
    if isinstance(ft, T.Message):
        return {}
    assert isinstance(ft, T.Prim)
    n = ft.name
    if n == "bool":
        return False
    if n in T.FLOAT_PRIMS:
        return 0.0
    if n == "uuid":
        import uuid as _uuid
        return _uuid.UUID(int=0)
    if n == "timestamp":
        return T.Timestamp(0, 0, 0)
    if n == "duration":
        return T.Duration(0, 0)
    return 0


def encoded_size(t: T.Type, value: Any) -> int:
    return len(encode(t, value))


def expected_varint_bytes_uniform(n_max: int) -> float:
    """Eq. 1: expected varint size for v uniform on [0, N]."""
    total = 0
    count = n_max + 1
    lo = 0
    for k in range(1, 6):
        hi = min(n_max, 2 ** (7 * k) - 1)
        if hi < lo:
            break
        bucket = hi - lo + 1
        total += k * bucket
        lo = hi + 1
        if lo > n_max:
            break
    return total / count
