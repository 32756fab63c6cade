"""The port's host codecs against the JAX package's, on the CPU.

Every workload of ``benchmarks/workloads.build_workloads()`` (the paper's
23 schemas), its type rebuilt as the port's by :func:`port_type` and its
value by :func:`port_value`, gives the same bytes in both packages:

* the Bebop wire codec and the protobuf-style ``varint`` baseline;
* ``FastStructDecoder.decode_canonical`` of JAX's wire bytes, re-encoded;
* ``batch_encode_fixed`` / ``batch_decode_fixed`` on every fixed-layout
  struct inside the workload's type (or the same refusal where there is
  none), and ``SpecializedBatchCodec`` on the uniform-length structs,
  whose ``decode_batch`` is a view of the caller's buffer.

Hypothesis properties mirror ``tests/test_property.py``'s codec
properties through both packages (derandomized, with no example
database, so a run writes nothing to the repository).
"""
import uuid

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from benchmarks.workloads import build_workloads
from repro.core import fastwire as jfastwire
from repro.core import types as JT
from repro.core import varint as jvarint
from repro.core import wire as jwire

from repro_torch.core import fastwire, varint, wire
from repro_torch.core import types as T

WORKLOADS = build_workloads()
NAMES = sorted(WORKLOADS)
PROPS = dict(deadline=None, derandomize=True, database=None)


def port_type(t, _memo=None):
    """The JAX package's type tree ``t`` rebuilt from the port's nodes
    (recursive types through a memo of the named nodes)."""
    memo = {} if _memo is None else _memo
    if id(t) in memo:
        return memo[id(t)]
    if isinstance(t, JT.Enum):
        out = T.Enum(t.name, t.members, base=port_type(t.base, memo),
                     doc=t.doc)
    elif isinstance(t, JT.Prim):
        out = T.Prim(t.name)
    elif isinstance(t, JT.StringT):
        out = T.STRING
    elif isinstance(t, JT.FixedArray):
        out = T.FixedArray(port_type(t.elem, memo), t.count)
    elif isinstance(t, JT.Array):
        out = T.Array(port_type(t.elem, memo))
    elif isinstance(t, JT.MapT):
        out = T.MapT(port_type(t.key, memo), port_type(t.value, memo))
    elif isinstance(t, (JT.Struct, JT.Message)):
        out = (T.Struct(t.name, [], mutable=t.mutable, doc=t.doc)
               if isinstance(t, JT.Struct) else T.Message(t.name, [],
                                                           doc=t.doc))
        memo[id(t)] = out
        out.fields.extend(T.Field(f.name, port_type(f.type, memo), tag=f.tag,
                                  doc=f.doc, deprecated=f.deprecated)
                          for f in t.fields)
    elif isinstance(t, JT.Union):
        out = T.Union(t.name, [], doc=t.doc)
        memo[id(t)] = out
        out.branches.extend(T.Branch(b.name, b.discriminator,
                                     port_type(b.type, memo))
                            for b in t.branches)
    else:
        raise AssertionError(f"no port type for {t!r}")
    memo[id(t)] = out
    return out


def port_value(v):
    """A JAX-package value rebuilt with the port's value classes."""
    if isinstance(v, JT.Timestamp):
        return T.Timestamp(v.sec, v.ns, v.offset_ms)
    if isinstance(v, JT.Duration):
        return T.Duration(v.sec, v.ns)
    if isinstance(v, JT.UnionValue):
        return T.UnionValue(v.discriminator, v.name, port_value(v.value))
    if isinstance(v, dict):
        return {k: port_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [port_value(x) for x in v]
    return v


def _pair(name):
    w = WORKLOADS[name]
    return w.schema, w.value, port_type(w.schema), port_value(w.value)


def _raised(fn, *args):
    with pytest.raises(Exception) as ei:
        fn(*args)
    return type(ei.value).__name__, str(ei.value)


def test_port_type_rebuilds_every_workload():
    assert len(WORKLOADS) == 23
    for name in NAMES:
        jt, _, pt, _ = _pair(name)
        assert type(pt).__module__ == "repro_torch.core.types"
        assert pt.type_name() == jt.type_name()
        assert pt.static_size() == jt.static_size()


@pytest.mark.parametrize("name", NAMES)
def test_wire_bytes_equal(name):
    jt, jv, pt, pv = _pair(name)
    blob = wire.encode(pt, pv)
    assert blob == jwire.encode(jt, jv)
    assert wire.encoded_size(pt, pv) == len(blob)
    assert wire.encode(pt, wire.decode(pt, blob)) == blob


@pytest.mark.parametrize("name", NAMES)
def test_varint_bytes_equal(name):
    jt, jv, pt, pv = _pair(name)
    blob = varint.encode(pt, pv)
    assert blob == jvarint.encode(jt, jv)
    assert varint.encoded_size(pt, pv) == jvarint.encoded_size(jt, jv)
    # the port decodes JAX's bytes to a value it encodes back to them
    assert varint.encode(pt, varint.decode(pt, blob)) == blob


@pytest.mark.parametrize("name", NAMES)
def test_fast_decoder_canonical_reencodes(name):
    jt, jv, pt, _ = _pair(name)
    blob = jwire.encode(jt, jv)
    dec = fastwire.FastStructDecoder(pt)
    v = dec.decode_canonical(blob)
    assert wire.encode(pt, v) == blob
    _, end = dec.decode_with_end(blob)
    assert end == len(blob) == jfastwire.FastStructDecoder(
        jt).decode_with_end(blob)[1]


def _static_structs(t, seen=None):
    """Every struct with a static layout inside type ``t``."""
    seen = set() if seen is None else seen
    if id(t) in seen:
        return []
    seen.add(id(t))
    out = []
    if isinstance(t, T.Struct) and fastwire.static_dtype(t) is not None \
            and t.fields:
        out.append(t)
    for f in getattr(t, "fields", []):
        out += _static_structs(f.type, seen)
    for b in getattr(t, "branches", []):
        out += _static_structs(b.type, seen)
    for sub in ("elem", "key", "value"):
        if isinstance(getattr(t, sub, None), T.Type):
            out += _static_structs(getattr(t, sub), seen)
    return out


def _random(dt, n, rng):
    """``n`` items of dtype ``dt`` from random bytes (so every bit pattern
    of every field occurs), but timestamps and durations valid: ns in
    [0, 1e9) and a non-negative sec."""
    out = np.frombuffer(rng.bytes(n * dt.itemsize), dtype=dt).copy()

    def fix(a):
        if a.dtype.names is None:
            return
        if {"sec", "ns"} <= set(a.dtype.names):
            a["ns"] %= 10 ** 9
            a["sec"] = np.abs(a["sec"] // 2)
            return
        for name in a.dtype.names:
            fix(a[name])
    fix(out)
    return out


def _columns(s, n, seed):
    """``n`` records of the fixed struct ``s`` as struct-of-arrays."""
    recs = _random(fastwire.static_dtype(s), n, np.random.default_rng(seed))
    return {f.name: recs[f.name] for f in s.fields}


@pytest.mark.parametrize("name", NAMES)
def test_batch_fixed_codecs_equal(name):
    jt, _, pt, _ = _pair(name)
    inner = _static_structs(pt)
    if not inner:
        # no fixed-layout struct anywhere: both refuse the workload alike
        assert _raised(fastwire.batch_encode_fixed, pt, {}) == _raised(
            jfastwire.batch_encode_fixed, jt, {})
        assert _raised(fastwire.batch_decode_fixed, pt, b"") == _raised(
            jfastwire.batch_decode_fixed, jt, b"")
        return
    for i, s in enumerate(inner):
        js = _jax_struct(jt, s.name)
        cols = _columns(s, 37, seed=i)
        blob = fastwire.batch_encode_fixed(s, cols)
        assert blob == jfastwire.batch_encode_fixed(js, cols)
        buf = bytearray(blob)
        view = fastwire.batch_decode_fixed(s, buf)
        assert np.shares_memory(view, np.frombuffer(buf, np.uint8))
        assert len(view) == 37 and view.tobytes() == blob
        assert view.tobytes() == jfastwire.batch_decode_fixed(js, blob
                                                              ).tobytes()
        # batch decode == N single decodes
        dec = fastwire.FastStructDecoder(s)
        item = view.dtype.itemsize
        for k in (0, 17, 36):
            assert dec.decode(blob, k * item).tobytes() == view[k].tobytes()
        assert _raised(fastwire.batch_decode_fixed, s, blob, 38) == _raised(
            jfastwire.batch_decode_fixed, js, blob, 38)


def _jax_struct(t, name, seen=None):
    seen = set() if seen is None else seen
    if id(t) in seen:
        return None
    seen.add(id(t))
    if isinstance(t, JT.Struct) and t.name == name:
        return t
    kids = [f.type for f in getattr(t, "fields", [])] + [
        b.type for b in getattr(t, "branches", [])] + [
        getattr(t, s) for s in ("elem", "key", "value")
        if isinstance(getattr(t, s, None), JT.Type)]
    for k in kids:
        hit = _jax_struct(k, name, seen)
        if hit is not None:
            return hit
    return None


def _uniform_columns(s, value, n, seed):
    """``n`` records of struct ``s`` whose dynamic arrays all have the
    length they have in ``value``."""
    rng = np.random.default_rng(seed)
    cols = {}
    for f in s.fields:
        dt = fastwire.static_dtype(f.type)
        if dt is not None:
            cols[f.name] = _random(dt, n, rng)
            continue
        length = len(value[f.name])
        if f.type.elem.name == "bfloat16":
            cols[f.name] = rng.standard_normal((n, length)).astype("<f4")
        else:
            ed = f.type.elem.np_dtype
            cols[f.name] = np.frombuffer(
                rng.bytes(n * length * ed.itemsize), ed).reshape(n, length)
    return cols


@pytest.mark.parametrize("name", NAMES)
def test_specialized_batch_codec_equal(name):
    jt, jv, pt, _ = _pair(name)
    got = None
    try:
        codec = fastwire.SpecializedBatchCodec(pt)
    except Exception as e:  # noqa: BLE001 - compared below
        got = (type(e).__name__, str(e))
    if got is not None:
        assert got == _raised(jfastwire.SpecializedBatchCodec, jt)
        return
    jcodec = jfastwire.SpecializedBatchCodec(jt)
    cols = _uniform_columns(pt, jv, 6, seed=5)
    blob = codec.encode_batch(cols)
    assert blob == jcodec.encode_batch(cols)
    assert codec.probe(blob).descr == jcodec.probe(blob).descr
    buf = bytearray(blob)
    out = codec.decode_batch(buf, 6)
    assert np.shares_memory(out, np.frombuffer(buf, np.uint8))
    assert out.tobytes() == blob == jcodec.decode_batch(blob, 6).tobytes()
    # each record of the batch is the workload's record on the wire
    item = out.dtype.itemsize
    one = wire.decode(pt, blob[2 * item:3 * item])
    assert wire.encode(pt, one) == blob[2 * item:3 * item]
    # a record whose length deviates from the frozen layout is refused
    bad = bytearray(blob)
    dyn = next(f for f in pt.fields if fastwire.static_dtype(f.type) is None)
    off = item + out.dtype.fields[dyn.name][1]
    bad[off:off + 4] = (len(jv[dyn.name]) + 1).to_bytes(4, "little")
    assert _raised(codec.decode_batch, bytes(bad), 6) == _raised(
        jcodec.decode_batch, bytes(bad), 6)


VARINTS = [0, 1, 127, 128, 300, 2**14 - 1, 2**14, 2**21, 2**28 - 1,
           2**32 - 1, 2**35 + 7, 2**56, 2**63, 2**64 - 1]


def test_varint_primitives_equal():
    out, jout = bytearray(), bytearray()
    for v in VARINTS:
        varint.write_uvarint(out, v)
        jvarint.write_uvarint(jout, v)
        assert varint.uvarint_size(v) == jvarint.uvarint_size(v)
    assert out == jout
    assert varint.read_packed_uvarints(out) == VARINTS == \
        jvarint.read_packed_uvarints(jout)
    pos, vals = 0, []
    while pos < len(out):
        v, pos = varint.read_uvarint(out, pos)
        vals.append(v)
    assert vals == VARINTS
    for v in (0, -1, 1, -2**31, 2**31 - 1, -2**63, 2**63 - 1):
        assert varint.zigzag(v) == jvarint.zigzag(v)
        assert varint.unzigzag(varint.zigzag(v)) == v


@pytest.mark.parametrize("body", [
    b"", b"\x80", b"\xff" * 11 + b"\x01",
    # a 10-byte varint whose top byte exceeds 1: past 64 bits, the
    # scalar loop's Python ints
    b"\x01" + b"\xff" * 9 + b"\x7f" + b"\x05",
    b"\xff" * 9 + b"\x01"])
def test_read_packed_uvarints_corners_equal(body):
    def run(mod):
        try:
            return ("ok", mod.read_packed_uvarints(body))
        except Exception as e:  # noqa: BLE001 - compared across packages
            return (type(e).__name__, str(e))
    assert run(varint) == run(jvarint)


# -- properties through both packages (mirroring tests/test_property.py) --

# An explicit alphabet (ASCII plus multi-byte code points up to four UTF-8
# bytes) keeps Hypothesis from building its charmap cache, which would
# rewrite the tracked `.hypothesis/unicode_data` file on every run.
_ALPHABET = ("abcxyzABCXYZ019 _-.,\\\"'\t\n\x00\x7f"
             "\u00e9\u00df\u03a9\u0416\u4e2d\u6587\uffff"
             "\U0001f600\U0001f680\U0010ffff")

_SCALARS = [
    (JT.BOOL, st.booleans()),
    (JT.UINT8, st.integers(0, 255)),
    (JT.INT16, st.integers(-2**15, 2**15 - 1)),
    (JT.UINT32, st.integers(0, 2**32 - 1)),
    (JT.INT64, st.integers(-2**63, 2**63 - 1)),
    (JT.FLOAT32, st.floats(width=32, allow_nan=False)),
    (JT.FLOAT64, st.floats(allow_nan=False)),
    (JT.UINT128, st.integers(0, 2**128 - 1)),
    (JT.STRING, st.text(alphabet=_ALPHABET, max_size=40)),
]


@st.composite
def struct_and_value(draw, max_fields=5):
    n = draw(st.integers(1, max_fields))
    fields, value = [], {}
    for i in range(n):
        ftype, strat = draw(st.sampled_from(_SCALARS))
        if draw(st.booleans()):
            ftype = JT.Array(ftype)
            strat = st.lists(strat, max_size=8)
        fields.append(JT.Field(f"f{i}", ftype))
        value[f"f{i}"] = draw(strat)
    return JT.Struct("S", fields), value


def _norm(v):
    if isinstance(v, np.ndarray):
        return [_norm(x) for x in v.tolist()]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, (np.bool_, bool)):
        return bool(v)
    if isinstance(v, (np.integer, int)):
        return int(v)
    if isinstance(v, (np.floating, float)):
        return float(v)
    return v


@settings(max_examples=150, **PROPS)
@given(struct_and_value())
def test_prop_wire_bytes_and_fast_decoder(sv):
    js, v = sv
    ps = port_type(js)
    blob = wire.encode(ps, v)
    assert blob == jwire.encode(js, v)
    ref = wire.decode(ps, blob)
    assert _norm(ref) == _norm(v)
    fast = fastwire.FastStructDecoder(ps).decode_canonical(blob)
    assert _norm(fast) == _norm(ref) == _norm(
        jfastwire.FastStructDecoder(js).decode_canonical(blob))


@settings(max_examples=100, **PROPS)
@given(struct_and_value())
def test_prop_varint_bytes_and_roundtrip(sv):
    js, v = sv
    ps = port_type(js)
    blob = varint.encode(ps, v)
    assert blob == jvarint.encode(js, v)
    assert _norm(varint.decode(ps, blob)) == _norm(v)


@settings(max_examples=50, **PROPS)
@given(st.integers(0, 2**35))
def test_prop_expected_varint_size_equal(n_max):
    e = varint.expected_varint_bytes_uniform(n_max)
    assert e == jvarint.expected_varint_bytes_uniform(n_max)
    assert 1.0 <= e <= 5.0


@settings(max_examples=100, **PROPS)
@given(st.integers(-2**31, 2**31 - 1))
def test_prop_varint_int32_equal(v):
    b = varint.encode(T.INT32, v)
    assert b == jvarint.encode(JT.INT32, v)
    assert (len(b) == 11) == (v < 0)
    assert varint.decode(T.INT32, b) == v


_FIXED = [JT.UINT8, JT.INT16, JT.UINT32, JT.INT64, JT.FLOAT32, JT.FLOAT64,
          JT.UUID, JT.TIMESTAMP, JT.BFLOAT16]


@settings(max_examples=60, **PROPS)
@given(st.lists(st.sampled_from(_FIXED), min_size=1, max_size=6),
       st.integers(1, 4), st.integers(1, 40), st.integers(0, 2**32 - 1))
def test_prop_batch_decode_is_n_single_decodes(elems, width, n, seed):
    js = JT.Struct("R", [JT.Field(f"f{i}", e if i % 2 else
                                  JT.FixedArray(e, width))
                         for i, e in enumerate(elems)])
    ps = port_type(js)
    cols = _columns(ps, n, seed)
    blob = fastwire.batch_encode_fixed(ps, cols)
    assert blob == jfastwire.batch_encode_fixed(js, cols)
    view = fastwire.batch_decode_fixed(ps, blob)
    dec = fastwire.FastStructDecoder(ps)
    item = view.dtype.itemsize
    jdec = jfastwire.FastStructDecoder(js)
    for k in range(n):
        assert dec.decode(blob, k * item).tobytes() == view[k].tobytes()
        # the value model's round trip (a NaN bf16 comes back as the
        # canonical NaN in both packages)
        assert wire.encode(ps, dec.decode_canonical(blob, k * item)) == \
            jwire.encode(js, jdec.decode_canonical(blob, k * item))


def test_uuid_records_cross_packages():
    """A uuid field's 16 bytes are the canonical string's, in both."""
    u = uuid.UUID("12345678-9abc-def0-1234-56789abcdef0")
    s = port_type(JT.Struct("U", [JT.Field("id", JT.UUID)]))
    blob = wire.encode(s, {"id": u})
    assert blob == u.bytes == jwire.encode(
        JT.Struct("U", [JT.Field("id", JT.UUID)]), {"id": u})
    assert varint.decode(s, varint.encode(s, {"id": u}))["id"] == u
