"""The port's schema toolchain against the JAX package's, on the CPU.

Every comparison is of bytes or plain numbers, never of two packages'
objects:

* each source of ``tests/test_schema_lang.py``, the quickstart's schema,
  the CLI test's schema and the card smoke's ``embedding.bop`` compile in
  both packages to byte-equal descriptor sets, equal generated Python (the
  JAX text with ``repro.core`` read as ``repro_torch.core``), equal method
  ids, constants and decorator exports, and equal ``run_plugin`` bytes;
  the port's generated module round-trips through the JAX one's;
* bad sources raise the same exception class name and message in both;
  mini-Lua snippets give equal ``run_lua`` results;
* ``plan_device_layout`` (strict alignment on and off) and
  ``sort_fields_for_alignment`` plan every fixed struct compiled here as
  JAX's do, an enum field's column included;
* ``decode_page_device`` of a page with an enum and a bf16 column on the
  CPU is bit-equal to JAX's Pallas decode in interpret mode and to the
  host's zero-copy ``batch_decode_fixed`` view.
"""
import importlib.util
import os
import uuid

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import codegen as jcodegen
from repro.core import compiler as jcompiler
from repro.core import decorators as jdecorators
from repro.core import descriptor as jdescriptor
from repro.core import device as jdevice
from repro.core import fastwire as jfastwire
from repro.core import parser as jparser
from repro.core import schema as jschema
from repro.core import wire as jwire

from repro_torch.core import codegen, compiler, decorators, descriptor
from repro_torch.core import device, fastwire, parser, schema
from repro_torch.core import types as T
from repro_torch.core import wire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(relpath, name):
    """Load a file of the repository as a module without running its
    ``__main__`` block (its schema constants are what is wanted)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LANG = _module("tests/test_schema_lang.py", "_schema_lang_sources")
CLI = _module("tests/test_cli.py", "_cli_sources")
QUICKSTART = _module("examples/quickstart.py", "_quickstart_sources")

# chip_smoke.py's schema phase writes this as embedding.bop
EMBEDDING_BOP = '''edition = "2026"
package smoke
import "bebop/decorators.bop"
enum Kind : uint8 { QUERY = 0; DOCUMENT = 1; }
/// One record of the 1,536-wide embedding workload.
struct EmbeddingRecord { id: uuid; vector: bfloat16[1536]; model: uint32; kind: Kind; }
message SearchRequest { query(1): string; top_k(2): uint32; filters(3): map[string, string]; }
service Search { Embed(SearchRequest): EmbeddingRecord; }
'''

# the inline sources of tests/test_schema_lang.py's tests
NESTED = '''
struct Outer {
  struct Inner { a: int32; }
  export struct Pub { b: int32; }
  i: Outer.Inner;
}
local struct Priv { x: int32; }
'''
ENV = 'const string X = "$(BEBOP_TEST_VAR)/suffix";'

# an enum column between a float array and padding: the port's planner
# dropped it before the enum branch
ENUM_LAYOUT = '''
enum Status : uint8 { OFF = 0; ON = 1; }
enum Wide : uint16 { A = 0; B = 513; }
struct Rec { v: float32[4]; s: Status; pad: uint8[3]; }
struct Mixed { s: Status; w: Wide; x: float32; id: uuid; t: timestamp; h: bfloat16[3]; }
struct Packed { a: uint8; b: uint32; c: uint16; d: float64; }
'''

# every clause of the decorator language, the standard library's
# decorators, and constants of every literal kind
DECORATED = '''
edition = "2026"
package extra.decor
import "bebop/decorators.bop"
#decorator(tagged) {
  targets = ALL
  param label!: string
  param weight?: float64
  param count?: int32
  validate [[
    if weight ~= nil and weight < 0 then error("weight " .. weight .. " < 0")
    elseif count ~= nil and count > 9 then error("too many")
    end
  ]]
  export [[
    local w = weight or 1
    return { label = label .. "#" .. target.name, w = w * 2, half = w / 2,
             n = #label, kind = target.kind, c = count and count + 1,
             parts = { label, tostring(w), type(count) } }
  ]]
}
/// A decorated struct.
@tagged(label="pt", weight=1.5)
@deprecated(reason="use Point3")
struct Point { @validate_range(min=-1.0, max=1.0) x: float32; y: float32; }
@tagged(label="m", count=3)
mut struct Counter { n: uint64; }
@tagged(label="msg")
message Note {
  @deprecated
  text(1): string;
  @indexed
  owner(2): uuid;
  at(3): timestamp;
  ttl(4): duration;
}
service Notes {
  @tagged(label="get", weight=0)
  Get(Point): Note;
  Watch(Point): stream Note;
}
const bool ON = true;
const float64 RATIO = 2.5;
const int64 NEG = -42;
const uint8 SMALL = 0xff;
const duration LONG = "1h30m15.5s";
const duration TINY = "-250us";
const timestamp LOCAL = "2024-01-15T10:30:00.25+05:30";
const timestamp ODD = "2024-01-15T10:30:00+12:00:01.133";
const byte[] MAGIC = b"\\x00\\xffBEBOP\\n";
const string PATH = "$(BEBOP_TEST_VAR)/$(BEBOP_UNSET_VAR)x";
'''

SOURCES = {
    "basic": (LANG.BASIC, "basic.bop"),
    "env": (ENV, "<schema>"),
    "nested": (NESTED, "<schema>"),
    "cli": (CLI.SCHEMA, "demo.bop"),
    "quickstart": (QUICKSTART.SCHEMA, "quickstart.bop"),
    "embedding": (EMBEDDING_BOP, "embedding.bop"),
    "enum_layout": (ENUM_LAYOUT, "layout.bop"),
    "decorated": (DECORATED, "decorated.bop"),
}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("BEBOP_TEST_VAR", "hello")
    monkeypatch.delenv("BEBOP_UNSET_VAR", raising=False)


def _both(name):
    src, filename = SOURCES[name]
    return (jcompiler.compile_source(src, filename=filename),
            compiler.compile_source(src, filename=filename))


def _as_port_text(jax_text: str) -> str:
    return jax_text.replace("repro.core", "repro_torch.core")


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_descriptor_set_bytes_equal(name):
    js, ps = _both(name)
    blob = descriptor.encode_descriptor_set([ps])
    assert blob == jdescriptor.encode_descriptor_set([js])
    assert descriptor.topological_order(ps) == \
        jdescriptor.topological_order(js)
    assert list(ps.definitions) == list(js.definitions)
    # it decodes, and names every definition
    ds = descriptor.decode_descriptor_set(blob)
    names = [d["name"] for d in ds["schemas"][0]["definitions"]]
    assert sorted(names) == sorted(ps.definitions)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_generated_python_equal(name):
    js, ps = _both(name)
    text = codegen.generate_python(ps)
    assert text == _as_port_text(jcodegen.generate_python(js))
    assert "import repro.core" not in text and "from repro.core" not in text
    compile(text, f"<{name}>", "exec")


def _ids(s, pkg_schema):
    return [(n, m.name, m.id, m.kind, m.client_stream, m.server_stream)
            for n, d in s.definitions.items()
            if isinstance(d, pkg_schema.ServiceDef) for m in d.methods]


def _consts(s, pkg_schema, pkg_wire):
    """Each constant's value as the bytes of its type on the wire."""
    return [(n, d.type.type_name(), pkg_wire.encode(d.type, d.value),
             d.visibility)
            for n, d in s.definitions.items()
            if isinstance(d, pkg_schema.ConstDef)]


def _exports(s):
    out = []
    for n, d in s.definitions.items():
        for u in getattr(d, "decorators", None) or []:
            out.append((n, u.name, u.args, u.exported))
        for f in getattr(d, "fields", None) or []:
            for u in f.decorators:
                out.append((f"{n}.{f.name}", u.name, u.args, u.exported))
        for m in getattr(d, "methods", None) or []:
            for u in m.decorators:
                out.append((f"{n}/{m.name}", u.name, u.args, u.exported))
    return out


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_ids_constants_and_exports_equal(name):
    js, ps = _both(name)
    assert _ids(ps, schema) == _ids(js, jschema)
    assert _consts(ps, schema, wire) == _consts(js, jschema, jwire)
    assert _exports(ps) == _exports(js)
    assert [(n, getattr(d, "doc", ""), getattr(d, "visibility", None),
             ps.fqn(n)) for n, d in ps.definitions.items()] == \
        [(n, getattr(d, "doc", ""), getattr(d, "visibility", None),
          js.fqn(n)) for n, d in js.definitions.items()]


def test_constants_of_every_kind():
    _, ps = _both("decorated")
    assert ps["PATH"].value == "hello/x"
    assert (ps["LONG"].value.sec, ps["LONG"].value.ns) == (5415, 500_000_000)
    assert (ps["TINY"].value.sec, ps["TINY"].value.ns) == (0, -250_000)
    assert ps["ODD"].value.offset_ms == (12 * 3600 + 1) * 1000 + 133
    assert bytes(ps["MAGIC"].value) == b"\x00\xffBEBOP\n"
    exported = dict(ps["Point"].decorators[0].exported)
    assert exported.pop("kind")
    assert exported == {"label": "pt#Point", "w": 3.0, "half": 0.75, "n": 2,
                        "c": None, "parts": {1: "pt", 2: "1.5", 3: "nil"}}
    _, basic = _both("basic")
    assert basic["Profile"].field("email").decorators[0].exported[
        "index_name"] == "Profile_email_idx"


def _sample(t, rng, depth=0):
    """A value of port type ``t`` drawn from ``rng`` (recursive types stop
    growing after two levels)."""
    if isinstance(t, T.Enum):
        return list(t.members.values())[-1]
    if isinstance(t, T.StringT):
        return "s-%d-é" % rng.integers(1000)
    if isinstance(t, T.Prim):
        n = t.name
        if n == "bool":
            return bool(rng.integers(2))
        if n == "uuid":
            return uuid.UUID(bytes=rng.bytes(16))
        if n == "timestamp":
            return T.Timestamp(int(rng.integers(-2**40, 2**40)),
                               int(rng.integers(10**9)), -3600)
        if n == "duration":
            return T.Duration(int(rng.integers(2**40)),
                              int(rng.integers(10**9)))
        if n in ("int128", "uint128"):
            return int(rng.integers(2**62)) << 40
        if n in T.FLOAT_PRIMS:
            return float(np.float32(rng.standard_normal()).astype(
                np.float16))
        lo, hi = {"byte": (0, 255), "uint8": (0, 255), "int8": (-128, 127),
                  "int16": (-2**15, 2**15 - 1), "uint16": (0, 2**16 - 1),
                  "int32": (-2**31, 2**31 - 1), "uint32": (0, 2**32 - 1),
                  "int64": (-2**62, 2**62), "uint64": (0, 2**62)}[n]
        return int(rng.integers(lo, hi, endpoint=True))
    if isinstance(t, T.Array):
        count = t.count if isinstance(t, T.FixedArray) else (
            0 if depth > 2 else 3)
        items = [_sample(t.elem, rng, depth + 1) for _ in range(count)]
        if isinstance(t.elem, T.Prim) and t.elem.np_dtype is not None:
            dt = "<f4" if t.elem.name in ("bfloat16", "float16") \
                else t.elem.np_dtype
            return np.asarray(items, dtype=dt)
        return items
    if isinstance(t, T.MapT):
        return {_sample(t.key, rng, depth + 1): _sample(t.value, rng,
                                                       depth + 1)
                for _ in range(2)}
    if isinstance(t, T.Union):
        b = t.branches[-1]
        return T.UnionValue(b.discriminator, b.name,
                            _sample(b.type, rng, depth + 1))
    if isinstance(t, (T.Struct, T.Message)):
        return {f.name: _sample(f.type, rng, depth + 1) for f in t.fields}
    raise AssertionError(f"no sample for {t!r}")


def _record_classes(mod, s):
    return [(n, getattr(mod, n.replace(".", "_"))) for n, d in
            s.definitions.items() if isinstance(d, (T.Struct, T.Message))]


def _static_bytes(obj):
    return b"".join(np.asarray(getattr(obj, k)).tobytes()
                    for k in obj.__slots__)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_load_generated_round_trips_through_both(name):
    js, ps = _both(name)
    mod = codegen.load_generated(ps, f"port_{name}_gen")
    jmod = jcodegen.load_generated(js, f"jax_{name}_gen")
    assert mod.__source__ == _as_port_text(jmod.__source__)
    rng = np.random.default_rng(7)
    checked = 0
    for n, cls in _record_classes(mod, ps):
        jcls = getattr(jmod, n.replace(".", "_"))
        value = _sample(ps[n], rng)
        blob = cls(**value).encode()
        assert blob == wire.encode(ps[n], value)
        for c in (cls, jcls):
            back = c.decode(blob)
            if fastwire.static_dtype(ps[n]) is not None:
                assert _static_bytes(back) == blob
            else:
                assert back.encode() == blob
        checked += 1
    assert checked == len(_record_classes(mod, ps))


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_run_plugin_bytes_equal(name):
    js, _ = _both(name)
    ds = jdescriptor.decode_descriptor_set(
        jdescriptor.encode_descriptor_set([js]))
    req = jwire.encode(jdescriptor.CodeGeneratorRequest,
                       {"schemas": ds["schemas"], "parameter": "x=1"})
    got = codegen.run_plugin(req)
    assert got == jcodegen.run_plugin(req)
    resp = wire.decode(descriptor.CodeGeneratorResponse, got)
    assert "error" not in resp and len(resp["files"]) == 1
    # a request that does not decode gives the same error response
    assert codegen.run_plugin(b"\x01") == jcodegen.run_plugin(b"\x01")


def _cycle_loader(path, importer):
    return 'import "a.bop"\nstruct B { x: int32; }'


BAD_SOURCES = {
    "lex_char": "struct S { x: int32; } $",
    "lex_string": 'const string X = "open',
    "lex_escape": 'const string X = "\\q";',
    "lex_raw_block": "#decorator(d) { targets = ALL export [[ return 1 }",
    "parse_missing_colon": "struct S { x int32; }",
    "parse_keyword": "strukt S { x: int32; }",
    "parse_fixed_size": "struct S { x: int32[n]; }",
    "parse_bad_tag": "message M { a(0): int32; }",
    "parse_duplicate_tag": "message M { a(1): int32; b(1): int32; }",
    "unknown_type": "struct S { x: not_a_type; }",
    "unknown_base_service": "service S with Nope { }",
    "bad_duration": 'const duration D = "10 parsecs";',
    "bad_timestamp": 'const timestamp T0 = "yesterday";',
    "duplicate": "struct S { x: int32; }\nstruct S { y: int32; }",
    "missing_import": 'import "nowhere.bop"\nstruct S { x: int32; }',
    "decorator_target": '''
import "bebop/decorators.bop"
@indexed(unique=true)
struct S { x: float32; }
''',
    # a struct's decorator target is named after the parser's lazy class,
    # so "targets = STRUCT" refuses a struct in both packages alike
    "struct_target": '''
#decorator(s) { targets = STRUCT }
@s struct S { x: int32; }
''',
    "validate_block": '''
import "bebop/decorators.bop"
struct S { @validate_range(min=5.0, max=1.0) x: float32; }
''',
    "lua_error": '''
#decorator(boom) { targets = ALL export [[ error("boom " .. target.name) ]] }
@boom struct S { x: int32; }
''',
    "lua_syntax": '''
#decorator(bad) { targets = ALL export [[ return { a = } ]] }
@bad struct S { x: int32; }
''',
    "unknown_decorator": "@nope struct S { x: int32; }",
    "missing_param": '''
import "bebop/decorators.bop"
struct S { @validate_range(min=1.0) x: float32; }
''',
    "unknown_param": '''
import "bebop/decorators.bop"
@deprecated(why="x") struct S { x: float32; }
''',
    "export_not_table": '''
#decorator(num) { targets = ALL export [[ return 3 ]] }
@num struct S { x: int32; }
''',
    "import_cycle": 'import "a.bop"\nstruct A { b: int32; }',
}


def _raised(pkg_compiler, src):
    loader = _cycle_loader if src.startswith('import "a.bop"') else None
    with pytest.raises(Exception) as ei:
        pkg_compiler.compile_source(src, filename="a.bop", loader=loader)
    return type(ei.value).__name__, str(ei.value)


@pytest.mark.parametrize("case", sorted(BAD_SOURCES))
def test_bad_sources_raise_alike(case):
    src = BAD_SOURCES[case]
    got = _raised(compiler, src)
    assert got == _raised(jcompiler, src)
    # every refusal is a schema error of the port's own classes
    with pytest.raises(T.SchemaError):
        compiler.compile_source(
            src, filename="a.bop",
            loader=_cycle_loader if case == "import_cycle" else None)


def test_lex_rejects_invalid_utf8_alike(tmp_path):
    p = tmp_path / "bad.bop"
    p.write_bytes(b"struct S { x: int32; } // \xff\xfe")
    got = jgot = None
    try:
        compiler.compile_file(str(p))
    except Exception as e:  # noqa: BLE001 - compared below
        got = (type(e).__name__, str(e))
    try:
        jcompiler.compile_file(str(p))
    except Exception as e:  # noqa: BLE001 - compared below
        jgot = (type(e).__name__, str(e))
    assert got == jgot and got is not None


LUA = {
    "arith": "return 1 + 2 * 3 - 4 / 8",
    "int_float_mix": ("return { a = 7 % 3, b = 7.5 % 2, c = 2 * 1.5, "
                      "d = 9 / 3 }"),
    "concat_numbers": 'return 1 .. "-" .. 2.0 .. "-" .. 2.5 .. "-" .. 10 / 4',
    "concat_bool_nil": ("return tostring(true) .. tostring(nil) .. "
                        "tostring(3.0)"),
    "or_operand": 'return { a = nil or "x", b = false or 0, c = 1 or 2 }',
    "and_operand": 'return { a = nil and 1, b = 1 and "y", c = false and 1 }',
    "not": "return { a = not nil, b = not 0, c = not false }",
    "compare": 'return { 1 < 2, 2 <= 2, "a" < "b", 1 == 1.0, 1 ~= 2 }',
    "if_elseif": ('local x = 5 if x > 9 then return "a" elseif x > 3 then '
                  'return "b" else return "c" end'),
    "nested_tables": ('local t = { a = { b = { 1, 2, "three" } }, '
                      '["k k"] = 4 } return t'),
    "index_assign": 'local t = {} t.x = 1 t["y"] = t.x + 1 return t',
    "len": 'return { #"hello", #{ 1, 2, 3 } }',
    "tonumber": 'return { tonumber("2.5"), tonumber(3), type(tonumber("4")) }',
    "type": ('return { type(nil), type(true), type(1), type("s"), '
             'type({}) }'),
    "locals_pad": "local a, b, c = 1, 2 return { a = a, b = b, c = c }",
    "env": "return target.parent .. '.' .. target.name .. '=' .. unique",
    "unknown_name_nil": "return undefined_thing",
    "no_return": "local a = 1",
    "unary_minus": "return -3 + -(-2.5)",
    "string_escape": 'return "tab\\there" .. \'q\\\'s\'',
}

LUA_ERRORS = {
    "error_builtin": 'error("boom " .. 1.0)',
    "error_table": "error({})",
    "bad_char": "return 1 @ 2",
    "expect": "return { a = }",
    "then": "if 1 return 2 end",
}

_LUA_ENV = {"target": {"kind": "FIELD", "name": "email", "parent": "User"},
            "unique": "yes"}


def _lua(pkg, src):
    try:
        return ("ok", pkg.run_lua(src, dict(_LUA_ENV)))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", sorted(LUA) + sorted(LUA_ERRORS))
def test_run_lua_equal(case):
    src = LUA.get(case) or LUA_ERRORS[case]
    got = _lua(decorators, src)
    want = _lua(jdecorators, src)
    assert got == want
    assert repr(got) == repr(want)      # 2 and 2.0 differ here
    assert (got[0] == "ok") == (case in LUA)


def _fixed_structs():
    for name in sorted(SOURCES):
        js, ps = _both(name)
        for n, d in ps.definitions.items():
            if isinstance(d, T.Struct) and \
                    fastwire.static_dtype(d) is not None:
                yield name, n, js[n], d


FIXED = [pytest.param(j, p, id=f"{name}-{n}")
         for name, n, j, p in _fixed_structs()]


def _plan(pkg_device, s, **kw):
    try:
        lay = pkg_device.plan_device_layout(s, **kw)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))
    return (lay.struct_name, lay.stride,
            [(c.name, c.offset, c.count, c.wire_dtype, c.elem_size)
             for c in lay.columns])


@pytest.mark.parametrize("js,ps", FIXED)
@pytest.mark.parametrize("strict", [True, False])
def test_device_plan_equal(js, ps, strict):
    assert _plan(device, ps, strict_align=strict) == \
        _plan(jdevice, js, strict_align=strict)


@pytest.mark.parametrize("js,ps", FIXED)
def test_sort_fields_for_alignment_equal(js, ps):
    sp, sj = (device.sort_fields_for_alignment(ps),
              jdevice.sort_fields_for_alignment(js))
    assert isinstance(sp, T.Struct)
    assert [f.name for f in sp.fields] == [f.name for f in sj.fields]
    assert (sp.name, sp.mutable, sp.doc) == (sj.name, sj.mutable, sj.doc)
    assert _plan(device, sp, strict_align=False) == \
        _plan(jdevice, sj, strict_align=False)
    assert fastwire.static_dtype(sp).descr == \
        jfastwire.static_dtype(sj).descr


def test_enum_field_keeps_its_column():
    _, ps = _both("enum_layout")
    lay = device.plan_device_layout(ps["Rec"])
    assert [(c.name, c.offset, c.count, c.wire_dtype) for c in lay.columns] \
        == [("v", 0, 4, "float32"), ("s", 16, 1, "uint8"),
            ("pad", 17, 3, "uint8")]
    assert lay.column("s").elem_size == 1
    with pytest.raises(KeyError):
        lay.column("nope")
    _, emb = _both("embedding")
    lay = device.plan_device_layout(emb["EmbeddingRecord"])
    assert (lay.stride, [c.name for c in lay.columns]) == (
        3093, ["id", "vector", "model", "kind"])
    assert lay.column("kind").as_field("uint8") == (3092, 1, "uint8", "uint8")
    # the unaligned u32 after an u8 is refused only under strict alignment
    with pytest.raises(T.SchemaError, match="sort_fields_for_alignment"):
        device.plan_device_layout(ps["Packed"])
    assert device.plan_device_layout(ps["Packed"], strict_align=False
                                     ).column("b").offset == 1


def test_resolve_gives_the_ports_own_types():
    _, ps = _both("basic")
    for n in ("Point", "Profile", "Result", "Status"):
        assert isinstance(ps[n], (T.Struct, T.Message, T.Union, T.Enum))
        assert type(ps[n]).__module__.startswith(("repro_torch.core",))
    assert fastwire.static_dtype(ps["Point"]).itemsize == 8
    assert isinstance(parser.parse_schema("struct S { x: int32; }")["S"],
                      T.Struct)
    assert (parser.parse_duration("1h30m").sec,
            parser.parse_iso8601("2024-01-15T10:30:00.5Z").ns) == (
        jparser.parse_duration("1h30m").sec,
        jparser.parse_iso8601("2024-01-15T10:30:00.5Z").ns)


def _enum_page(s, n, seed):
    """``n`` records of the fixed struct ``s`` from ``seed``: random bytes,
    with bf16 values finite and enum members valid."""
    rng = np.random.default_rng(seed)
    dt = fastwire.static_dtype(s)
    recs = np.frombuffer(rng.bytes(n * dt.itemsize), dtype=dt).copy()
    for f in s.fields:
        ft = f.type
        elem = ft.elem if isinstance(ft, T.FixedArray) else ft
        if isinstance(elem, T.Enum):
            recs[f.name] = rng.choice(list(elem.members.values()),
                                      recs[f.name].shape)
        elif isinstance(elem, T.Prim) and elem.name == "bfloat16":
            recs[f.name] = T.f32_array_to_bf16(rng.standard_normal(
                recs[f.name].shape).astype("<f4"))
    return recs


@pytest.mark.parametrize("source,struct,n", [
    ("enum_layout", "Rec", 8), ("enum_layout", "Mixed", 5),
    ("embedding", "EmbeddingRecord", 4)])
def test_decode_page_device_with_enum_column_equals_jax(source, struct, n):
    js, ps = _both(source)
    s = ps[struct]
    recs = _enum_page(s, n, seed=11)
    payload = np.frombuffer(recs.tobytes(), np.uint8).reshape(n, -1)
    lay = device.plan_device_layout(s, strict_align=False)
    assert any(c.name in ("s", "kind") for c in lay.columns)
    cols = device.decode_page_device(torch.from_numpy(payload.copy()), lay)
    want = jdevice.decode_page_device(
        jnp.asarray(payload), jdevice.plan_device_layout(
            js[struct], strict_align=False), impl="pallas")
    assert list(cols) == list(want)
    for name, col in cols.items():
        w = np.asarray(want[name])
        assert col.numpy().dtype == w.dtype, name
        assert col.numpy().tobytes() == w.tobytes(), name
    # and the host's zero-copy view, converted as the model reads it
    buf = bytearray(payload.tobytes())
    view = fastwire.batch_decode_fixed(s, buf, n)
    assert np.shares_memory(view, np.frombuffer(buf, np.uint8))
    for c in lay.columns:
        host = np.asarray(view[c.name]).reshape(n, c.count)
        if c.wire_dtype == "bfloat16":
            host = T.bf16_array_to_f32(host)
        else:
            host = host.astype(device.default_out_dtype(c.wire_dtype))
        assert cols[c.name].numpy().tobytes() == host.tobytes(), c.name
