"""Branchless vectorized Bebop decode/encode (the paper's performance claim).

The wire format guarantees every type is fixed-width or sits behind a 4-byte
count.  Two consequences, exploited here:

1.  A struct made only of fixed-width fields has a *static layout*, so a batch
    of N records is exactly an ``np.frombuffer`` with a structured dtype —
    one pointer assignment, zero per-record work, zero data-dependent
    branches.  This is the §4.4 "decode is pointer assignment / 86% of memory
    bandwidth" path.

2.  A struct with dynamic arrays still decodes branchlessly when array
    lengths are *uniform across a batch* (the ML case: every embedding in a
    page is 1536-dim).  We read the lengths once from the first record,
    specialize the layout, and decode the batch as strided views
    ("shape-specialized decode").

Single-record decode is also plan-compiled: the schema is walked once at
construction into a flat list of (offset, view) steps so the per-record work
is a handful of numpy view constructions — the Python analogue of bebopc's
generated C.

Copied unchanged from the JAX package's ``core/fastwire.py``: the page
codecs (``serving/service.py``) and the device layout planner
(``core/device.py``) use :func:`static_dtype`, generated modules the
plan-compiled :class:`FastStructDecoder`.
"""
from __future__ import annotations

import struct as _struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from . import types as T

__all__ = [
    "static_dtype",
    "batch_decode_fixed",
    "batch_encode_fixed",
    "FastStructDecoder",
    "SpecializedBatchCodec",
]


# --------------------------------------------------------------------------
# Static layouts
# --------------------------------------------------------------------------

_TIMESTAMP_DT = np.dtype([("sec", "<i8"), ("ns", "<i4"), ("offset_ms", "<i4")])
_DURATION_DT = np.dtype([("sec", "<i8"), ("ns", "<i4")])


def _prim_dtype(p: T.Prim) -> np.dtype:
    if p.name == "uuid":
        return np.dtype(("u1", (16,)))
    if p.name in ("int128", "uint128"):
        return np.dtype(("u1", (16,)))
    if p.name == "timestamp":
        return _TIMESTAMP_DT
    if p.name == "duration":
        return _DURATION_DT
    assert p.np_dtype is not None
    return p.np_dtype


def static_dtype(t: T.Type) -> Optional[np.dtype]:
    """Packed little-endian numpy dtype for a fixed-width type, else None.

    The returned dtype's itemsize equals the wire size exactly (no padding),
    so ``np.frombuffer(page, dtype=static_dtype(s))`` IS the decoder.
    """
    if isinstance(t, T.Enum):
        return t.base.np_dtype
    if isinstance(t, T.Prim):
        return _prim_dtype(t)
    if isinstance(t, T.FixedArray):
        ed = static_dtype(t.elem)
        if ed is None:
            return None
        return np.dtype((ed, (t.count,)))
    if isinstance(t, T.Struct):
        fields = []
        for f in t.fields:
            fd = static_dtype(f.type)
            if fd is None:
                return None
            fields.append((f.name, fd))
        dt = np.dtype(fields)
        assert dt.itemsize == t.static_size(), (dt.itemsize, t.static_size())
        return dt
    return None


def batch_decode_fixed(s: T.Struct, buf, count: Optional[int] = None,
                       offset: int = 0) -> np.ndarray:
    """Zero-copy batch decode of ``count`` fixed-layout structs.

    Returns a structured array *view* into ``buf`` — the decode itself is a
    single pointer assignment, exactly the paper's claim.
    """
    dt = static_dtype(s)
    if dt is None:
        raise T.DecodeError(f"struct {s.name} has no static layout")
    mv = memoryview(buf)[offset:]
    if count is None:
        count = len(mv) // dt.itemsize
    need = count * dt.itemsize
    if len(mv) < need:
        raise T.DecodeError(f"batch decode overrun: need {need}, have {len(mv)}")
    return np.frombuffer(mv[:need], dtype=dt)


def batch_encode_fixed(s: T.Struct, columns: Dict[str, np.ndarray]) -> bytes:
    """Encode a struct-of-arrays into N consecutive fixed-layout records."""
    dt = static_dtype(s)
    if dt is None:
        raise T.EncodeError(f"struct {s.name} has no static layout")
    names = [f.name for f in s.fields]
    n = len(np.asarray(columns[names[0]]))
    out = np.zeros(n, dtype=dt)
    for f in s.fields:
        col = columns[f.name]
        sub = out[f.name]
        target = sub.dtype
        if f.type == T.BFLOAT16 or (
                isinstance(f.type, T.FixedArray) and f.type.elem == T.BFLOAT16):
            col = np.asarray(col)
            if col.dtype.kind == "f":
                col = T.f32_array_to_bf16(col.astype("<f4"))
            out[f.name] = col.reshape(sub.shape)
        elif target.names:  # timestamp / duration sub-struct
            out[f.name] = col
        else:
            out[f.name] = np.asarray(col).reshape(sub.shape)
    return out.tobytes()


# --------------------------------------------------------------------------
# Plan-compiled single-record decode
# --------------------------------------------------------------------------


class FastStructDecoder:
    """Schema-compiled single-record decoder.

    Construction walks the schema once and emits a flat plan.  ``decode``
    executes the plan with numpy views for all numeric arrays (no per-element
    Python) and raw slices for fixed blobs.  For fully static structs it
    collapses to a single ``np.frombuffer``.
    """

    def __init__(self, t: T.Type):
        self.type = t
        self.static = static_dtype(t) if isinstance(t, T.Struct) else None
        self._plan = _compile(t)

    def decode(self, buf, offset: int = 0):
        """Fastest decode.  Static structs return a structured-record VIEW
        (uuid/int128/timestamp fields as raw sub-arrays — the zero-copy
        representation the paper measures).  Use decode_canonical for the
        reference value model."""
        if self.static is not None:
            rec = np.frombuffer(
                memoryview(buf)[offset:offset + self.static.itemsize],
                dtype=self.static)[0]
            return rec
        v, _ = self._plan(memoryview(buf), offset)
        return v

    def decode_canonical(self, buf, offset: int = 0):
        """Decode to the same value model as the reference codec."""
        v, _ = self._plan(memoryview(buf), offset)
        return v

    def decode_with_end(self, buf, offset: int = 0):
        if self.static is not None:
            return self.decode(buf, offset), offset + self.static.itemsize
        return self._plan(memoryview(buf), offset)


_u32 = _struct.Struct("<I").unpack_from


def _compile(t: T.Type, _cache: Optional[dict] = None
             ) -> Callable[[memoryview, int], Tuple[Any, int]]:
    """Compile a type to a (buf, offset) -> (value, end) closure.

    Recursive types (trees, JSON unions) are handled with a trampoline:
    the cache holds a cell that forwards to the real decoder once built.
    """
    if _cache is None:
        _cache = {}
    key = id(t)
    if key in _cache:
        cell = _cache[key]

        def forward(buf, off, _cell=cell):
            return _cell[0](buf, off)
        return forward
    if isinstance(t, (T.Struct, T.Message, T.Union)):
        cell: list = [None]
        _cache[key] = cell
        fn = _compile_inner(t, _cache)
        cell[0] = fn
        return fn
    return _compile_inner(t, _cache)


def _compile_inner(t: T.Type, _cache: dict
                   ) -> Callable[[memoryview, int], Tuple[Any, int]]:
    if isinstance(t, T.Enum):
        return _compile(t.base, _cache)
    if isinstance(t, T.Prim):
        return _compile_prim(t)
    if isinstance(t, T.StringT):
        def d_string(buf, off):
            n = _u32(buf, off)[0]
            end = off + 4 + n + 1
            return bytes(buf[off + 4:off + 4 + n]).decode("utf-8"), end
        return d_string
    if isinstance(t, T.FixedArray):
        return _compile_fixed_array(t, _cache)
    if isinstance(t, T.Array):
        return _compile_array(t, _cache)
    if isinstance(t, T.MapT):
        kd, vd = _compile(t.key, _cache), _compile(t.value, _cache)

        def d_map(buf, off):
            n = _u32(buf, off)[0]
            off += 4
            out = {}
            for _ in range(n):
                k, off = kd(buf, off)
                v, off = vd(buf, off)
                out[k] = v
            return out, off
        return d_map
    if isinstance(t, T.Struct):
        return _compile_struct(t, _cache)
    if isinstance(t, T.Message):
        return _compile_message(t, _cache)
    if isinstance(t, T.Union):
        return _compile_union(t, _cache)
    raise T.SchemaError(f"cannot compile decoder for {t!r}")


def _compile_prim(t: T.Prim):
    name, size = t.name, t.size
    if t.fmt is not None:
        unpack = _struct.Struct(t.fmt).unpack_from
        if name == "bool":
            def d_bool(buf, off):
                return buf[off] != 0, off + 1
            return d_bool

        def d_scalar(buf, off, _u=unpack, _s=size):
            return _u(buf, off)[0], off + _s
        return d_scalar
    if name == "bfloat16":
        def d_bf16(buf, off):
            raw = _struct.unpack_from("<H", buf, off)[0]
            return T.decode_bf16(raw), off + 2
        return d_bf16
    if name in ("int128", "uint128"):
        signed = name == "int128"

        def d_128(buf, off, _sg=signed):
            return int.from_bytes(bytes(buf[off:off + 16]), "little",
                                  signed=_sg), off + 16
        return d_128
    if name == "uuid":
        def d_uuid(buf, off):
            return T.uuid_from_wire(buf[off:off + 16]), off + 16
        return d_uuid
    if name == "timestamp":
        unpack = _struct.Struct("<qii").unpack_from

        def d_ts(buf, off, _u=unpack):
            sec, ns, ofs = _u(buf, off)
            return T.Timestamp(sec, ns, ofs), off + 16
        return d_ts
    if name == "duration":
        unpack = _struct.Struct("<qi").unpack_from

        def d_dur(buf, off, _u=unpack):
            sec, ns = _u(buf, off)
            return T.Duration(sec, ns), off + 12
        return d_dur
    raise T.SchemaError(f"unhandled primitive {name}")  # pragma: no cover


def _numeric_view(elem: T.Prim):
    """Bulk numpy view decoder for numeric elements (THE branchless path)."""
    dt, size, name = elem.np_dtype, elem.size, elem.name

    def view(buf, off, n):
        end = off + n * size
        arr = np.frombuffer(buf[off:end], dtype=dt)
        if name == "bfloat16":
            arr = T.bf16_array_to_f32(arr)
        elif name == "bool":
            arr = arr != 0
        return arr, end
    return view


def _compile_array(t: T.Array, _cache=None):
    if isinstance(t.elem, T.Prim) and t.elem.np_dtype is not None:
        view = _numeric_view(t.elem)

        def d_arr_bulk(buf, off):
            n = _u32(buf, off)[0]
            return view(buf, off + 4, n)
        return d_arr_bulk
    ed = _compile(t.elem, _cache)

    def d_arr(buf, off):
        n = _u32(buf, off)[0]
        off += 4
        out = []
        append = out.append
        for _ in range(n):
            v, off = ed(buf, off)
            append(v)
        return out, off
    return d_arr


def _compile_fixed_array(t: T.FixedArray, _cache=None):
    n = t.count
    if isinstance(t.elem, T.Prim) and t.elem.np_dtype is not None:
        view = _numeric_view(t.elem)

        def d_farr_bulk(buf, off):
            return view(buf, off, n)
        return d_farr_bulk
    ed = _compile(t.elem, _cache)

    def d_farr(buf, off):
        out = []
        append = out.append
        for _ in range(n):
            v, off = ed(buf, off)
            append(v)
        return out, off
    return d_farr


def _compile_struct(t: T.Struct, _cache=None):
    # Canonical per-field plan (the frombuffer fast path for fully-static
    # structs lives in FastStructDecoder.decode / the batch decoders, where
    # raw structured views are the point).
    steps: List[Tuple[str, Callable]] = [
        (f.name, _compile(f.type, _cache)) for f in t.fields]

    def d_struct(buf, off, _steps=tuple(steps)):
        out = {}
        for name, fn in _steps:
            out[name], off = fn(buf, off)
        return out, off
    return d_struct


def _compile_message(t: T.Message, _cache=None):
    by_tag = {}
    for f in t.fields:
        by_tag[f.tag] = (f.name, _compile(f.type, _cache))

    def d_msg(buf, off, _by_tag=by_tag):
        length = _u32(buf, off)[0]
        off += 4
        end = off + length
        out = {}
        while off < end:
            tag = buf[off]
            off += 1
            if tag == 0:
                break
            ent = _by_tag.get(tag)
            if ent is None:
                off = end
                break
            name, fn = ent
            out[name], off = fn(buf, off)
        return out, end
    return d_msg


def _compile_union(t: T.Union, _cache=None):
    by_disc = {b.discriminator: (b.name, _compile(b.type, _cache))
               for b in t.branches}

    def d_union(buf, off, _by=by_disc):
        length = _u32(buf, off)[0]
        off += 4
        end = off + length
        disc = buf[off]
        ent = _by.get(disc)
        if ent is None:
            raise T.DecodeError(f"unknown discriminator {disc}")
        name, fn = ent
        v, _ = fn(buf, off + 1)
        return T.UnionValue(disc, name, v), end
    return d_union


# --------------------------------------------------------------------------
# Shape-specialized batch codec (uniform-length dynamic arrays)
# --------------------------------------------------------------------------


class SpecializedBatchCodec:
    """Batch codec for structs whose dynamic arrays have *uniform* lengths.

    ML pages are like this: every Embedding1536 record in a page carries the
    same 1536-element array.  The codec probes the first record, freezes the
    layout (so the record stride becomes static), and thereafter the whole
    batch decodes as one structured view — restoring the pointer-assignment
    property for nominally dynamic schemas.

    Raises DecodeError if a record deviates from the frozen layout (the
    caller falls back to the reference decoder).
    """

    def __init__(self, s: T.Struct):
        if not all(_specializable(f.type) for f in s.fields):
            raise T.SchemaError(
                f"struct {s.name} has fields that cannot be shape-specialized")
        self.struct = s
        self._ref = FastStructDecoder(s)

    def probe(self, buf, offset: int = 0) -> np.dtype:
        """Derive the frozen per-record dtype from the record at ``offset``."""
        fields = []
        off = offset
        mv = memoryview(buf)
        for f in self.struct.fields:
            dt, off = _probe_field(f.type, mv, off)
            fields.append((f.name, dt))
        return np.dtype(fields)

    def decode_batch(self, buf, count: int, offset: int = 0) -> np.ndarray:
        dt = self.probe(buf, offset)
        mv = memoryview(buf)[offset:]
        need = count * dt.itemsize
        if len(mv) < need:
            raise T.DecodeError("specialized batch overrun")
        out = np.frombuffer(mv[:need], dtype=dt)
        # Validate the frozen lengths against each record's actual prefix —
        # a single vectorized comparison, still branchless per record.
        for f in self.struct.fields:
            _validate_frozen(f.type, out[f.name])
        return out

    def encode_batch(self, columns: Dict[str, np.ndarray]) -> bytes:
        n = None
        recs = []
        for f in self.struct.fields:
            col = np.asarray(columns[f.name])
            if n is None:
                n = col.shape[0]
            recs.append((f, col))
        fields = []
        for f, col in recs:
            fields.append((f.name, _frozen_encode_dtype(f.type, col)))
        dt = np.dtype(fields)
        out = np.zeros(n, dtype=dt)
        for f, col in recs:
            _frozen_encode_fill(f.type, out[f.name], col)
        return out.tobytes()


def _specializable(t: T.Type) -> bool:
    if static_dtype(t) is not None:
        return True
    if isinstance(t, T.Array) and not isinstance(t, T.FixedArray):
        return isinstance(t.elem, T.Prim) and t.elem.np_dtype is not None
    return False


def _probe_field(t: T.Type, mv: memoryview, off: int) -> Tuple[np.dtype, int]:
    sd = static_dtype(t)
    if sd is not None:
        return sd, off + sd.itemsize
    assert isinstance(t, T.Array)
    n = _u32(mv, off)[0]
    ed = t.elem.np_dtype
    dt = np.dtype([("len", "<u4"), ("data", (ed, (n,)))])
    return dt, off + 4 + n * ed.itemsize


def _validate_frozen(t: T.Type, col) -> None:
    if static_dtype(t) is not None:
        return
    lens = col["len"]
    want = col.dtype["data"].shape[0]
    if not bool((lens == want).all()):
        raise T.DecodeError("non-uniform array lengths in specialized batch")


def _frozen_encode_dtype(t: T.Type, col: np.ndarray) -> np.dtype:
    sd = static_dtype(t)
    if sd is not None:
        return sd
    assert isinstance(t, T.Array)
    n = col.shape[1]
    ed = t.elem.np_dtype
    return np.dtype([("len", "<u4"), ("data", (ed, (n,)))])


def _frozen_encode_fill(t: T.Type, dst, col: np.ndarray) -> None:
    sd = static_dtype(t)
    if sd is not None:
        if t == T.BFLOAT16 and col.dtype.kind == "f":
            col = T.f32_array_to_bf16(col.astype("<f4"))
        elif isinstance(t, T.FixedArray) and t.elem == T.BFLOAT16 \
                and col.dtype.kind == "f":
            col = T.f32_array_to_bf16(col.astype("<f4"))
        dst[...] = col.reshape(dst.shape)
        return
    assert isinstance(t, T.Array)
    n = col.shape[1]
    dst["len"] = n
    data = col
    if t.elem == T.BFLOAT16 and col.dtype.kind == "f":
        data = T.f32_array_to_bf16(col.astype("<f4"))
    dst["data"] = data
