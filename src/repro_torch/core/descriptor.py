"""Descriptor format (§6.3): the compiled schema, encoded in Bebop itself.

`DescriptorSet` is the root container; one `SchemaDescriptor` per source file;
`DefinitionDescriptor[]` topologically sorted (dependencies before
dependents) so plugins can generate code in a single pass.  Service methods
carry their stable 32-bit routing IDs.

Also defines the plugin protocol messages (§6.2): CodeGeneratorRequest /
CodeGeneratorResponse, and a reference in-process "plugin" that generates
Python codec modules (codegen.py does the actual generation).

Copied unchanged from the JAX package's ``core/descriptor.py``: a
descriptor set's bytes depend on the topological order, dict order and
method ids, and both packages must write the same bytes.
"""
from __future__ import annotations

from typing import List

from . import types as T
from . import wire
from .schema import ConstDef, Schema, ServiceDef

# --------------------------------------------------------------------------
# Descriptor schema — built with the Python DSL, encodable with our own wire.
# --------------------------------------------------------------------------

DefinitionKind = T.Enum("DefinitionKind", {
    "UNKNOWN": 0, "ENUM": 1, "STRUCT": 2, "MESSAGE": 3, "UNION": 4,
    "SERVICE": 5, "CONST": 6,
}, base=T.UINT8)

TypeKind = T.Enum("TypeKind", {
    "UNKNOWN": 0, "BOOL": 1, "BYTE": 2, "INT8": 3, "INT16": 4, "UINT16": 5,
    "INT32": 6, "UINT32": 7, "INT64": 8, "UINT64": 9, "FLOAT16": 10,
    "BFLOAT16": 11, "FLOAT32": 12, "FLOAT64": 13, "INT128": 14,
    "UINT128": 15, "UUID": 16, "TIMESTAMP": 17, "DURATION": 18,
    "STRING": 19, "ARRAY": 20, "FIXED_ARRAY": 21, "MAP": 22, "DEFINED": 23,
}, base=T.UINT8)

Visibility = T.Enum("Visibility", {"EXPORT": 0, "LOCAL": 1}, base=T.UINT8)

# TypeDescriptor is recursive: kind + optional element/key/value + name.
TypeDescriptor = T.Message("TypeDescriptor", [
    T.Field("kind", TypeKind, tag=1),
    T.Field("defined_name", T.STRING, tag=2),
    T.Field("fixed_count", T.UINT32, tag=3),
])
# recursive fields appended post-construction (self-reference)
TypeDescriptor.fields.append(T.Field("element", TypeDescriptor, tag=4))
TypeDescriptor.fields.append(T.Field("key", TypeDescriptor, tag=5))
TypeDescriptor.fields.append(T.Field("value", TypeDescriptor, tag=6))

DecoratorUsageDesc = T.Message("DecoratorUsageDesc", [
    T.Field("name", T.STRING, tag=1),
    T.Field("args_json", T.STRING, tag=2),      # canonical JSON of raw args
    T.Field("exported_json", T.STRING, tag=3),  # export-block output
])

FieldDescriptor = T.Message("FieldDescriptor", [
    T.Field("name", T.STRING, tag=1),
    T.Field("type", TypeDescriptor, tag=2),
    T.Field("tag", T.UINT8, tag=3),
    T.Field("documentation", T.STRING, tag=4),
    T.Field("deprecated", T.BOOL, tag=5),
    T.Field("decorators", T.Array(DecoratorUsageDesc), tag=6),
])

EnumMemberDescriptor = T.Struct("EnumMemberDescriptor", [
    T.Field("name", T.STRING),
    T.Field("value", T.INT64),
])

EnumDef = T.Message("EnumDef", [
    T.Field("base", TypeDescriptor, tag=1),
    T.Field("members", T.Array(EnumMemberDescriptor), tag=2),
])

StructDef = T.Message("StructDef", [
    T.Field("fields", T.Array(FieldDescriptor), tag=1),
    T.Field("mutable", T.BOOL, tag=2),
])

MessageDef = T.Message("MessageDef", [
    T.Field("fields", T.Array(FieldDescriptor), tag=1),
])

BranchDescriptor = T.Message("BranchDescriptor", [
    T.Field("name", T.STRING, tag=1),
    T.Field("discriminator", T.UINT8, tag=2),
    T.Field("type", TypeDescriptor, tag=3),
])

UnionDef = T.Message("UnionDef", [
    T.Field("branches", T.Array(BranchDescriptor), tag=1),
])

MethodDescriptor = T.Message("MethodDescriptor", [
    T.Field("name", T.STRING, tag=1),
    T.Field("request", TypeDescriptor, tag=2),
    T.Field("response", TypeDescriptor, tag=3),
    T.Field("client_stream", T.BOOL, tag=4),
    T.Field("server_stream", T.BOOL, tag=5),
    T.Field("routing_id", T.UINT32, tag=6),  # murmur3+lowbias32 (§6.3)
])

ServiceDefDesc = T.Message("ServiceDef", [
    T.Field("methods", T.Array(MethodDescriptor), tag=1),
])

ConstDefDesc = T.Message("ConstDef", [
    T.Field("type", TypeDescriptor, tag=1),
    T.Field("value_json", T.STRING, tag=2),
])

DefinitionDescriptor = T.Message("DefinitionDescriptor", [
    T.Field("kind", DefinitionKind, tag=1),
    T.Field("name", T.STRING, tag=2),
    T.Field("fqn", T.STRING, tag=3),
    T.Field("documentation", T.STRING, tag=4),
    T.Field("visibility", Visibility, tag=5),
    T.Field("decorators", T.Array(DecoratorUsageDesc), tag=6),
    T.Field("enum_def", EnumDef, tag=8),
    T.Field("struct_def", StructDef, tag=9),
    T.Field("message_def", MessageDef, tag=10),
    T.Field("union_def", UnionDef, tag=11),
    T.Field("service_def", ServiceDefDesc, tag=12),
    T.Field("const_def", ConstDefDesc, tag=13),
])
# nested definitions (tag 7 in the paper's listing)
DefinitionDescriptor.fields.insert(
    6, T.Field("nested", T.Array(DefinitionDescriptor), tag=7))

SchemaDescriptor = T.Message("SchemaDescriptor", [
    T.Field("package", T.STRING, tag=1),
    T.Field("edition", T.STRING, tag=2),
    T.Field("definitions", T.Array(DefinitionDescriptor), tag=3),
])

Version = T.Struct("Version", [
    T.Field("major", T.UINT16), T.Field("minor", T.UINT16),
    T.Field("patch", T.UINT16),
])

DescriptorSet = T.Message("DescriptorSet", [
    T.Field("schemas", T.Array(SchemaDescriptor), tag=1),
    T.Field("compiler_version", Version, tag=2),
])

# Plugin protocol (§6.2)
GeneratedFile = T.Message("GeneratedFile", [
    T.Field("name", T.STRING, tag=1),
    T.Field("content", T.STRING, tag=2),
    T.Field("insertion_point", T.STRING, tag=3),
])

Diagnostic = T.Message("Diagnostic", [
    T.Field("severity", T.STRING, tag=1),
    T.Field("message", T.STRING, tag=2),
    T.Field("file", T.STRING, tag=3),
    T.Field("line", T.UINT32, tag=4),
    T.Field("col", T.UINT32, tag=5),
])

CodeGeneratorRequest = T.Message("CodeGeneratorRequest", [
    T.Field("files_to_generate", T.Array(T.STRING), tag=1),
    T.Field("parameter", T.STRING, tag=2),
    T.Field("compiler_version", Version, tag=3),
    T.Field("schemas", T.Array(SchemaDescriptor), tag=4),
])

CodeGeneratorResponse = T.Message("CodeGeneratorResponse", [
    T.Field("error", T.STRING, tag=1),
    T.Field("files", T.Array(GeneratedFile), tag=2),
    T.Field("diagnostics", T.Array(Diagnostic), tag=3),
])

COMPILER_VERSION = {"major": 1, "minor": 0, "patch": 0}


# --------------------------------------------------------------------------
# Schema -> descriptor values
# --------------------------------------------------------------------------

_PRIM_TO_KIND = {
    "bool": 1, "byte": 2, "uint8": 2, "int8": 3, "int16": 4, "uint16": 5,
    "int32": 6, "uint32": 7, "int64": 8, "uint64": 9, "float16": 10,
    "bfloat16": 11, "float32": 12, "float64": 13, "int128": 14,
    "uint128": 15, "uuid": 16, "timestamp": 17, "duration": 18,
}


def type_descriptor(t: T.Type) -> dict:
    if isinstance(t, (T.Struct, T.Message, T.Union, T.Enum)):
        return {"kind": 23, "defined_name": t.name}
    if isinstance(t, T.Prim):
        return {"kind": _PRIM_TO_KIND[t.name]}
    if isinstance(t, T.StringT):
        return {"kind": 19}
    if isinstance(t, T.FixedArray):
        return {"kind": 21, "fixed_count": t.count,
                "element": type_descriptor(t.elem)}
    if isinstance(t, T.Array):
        return {"kind": 20, "element": type_descriptor(t.elem)}
    if isinstance(t, T.MapT):
        return {"kind": 22, "key": type_descriptor(t.key),
                "value": type_descriptor(t.value)}
    raise T.SchemaError(f"no descriptor for {t!r}")


def _dec_usages(decs) -> List[dict]:
    import json
    out = []
    for u in decs or []:
        d = {"name": u.name, "args_json": json.dumps(u.args, default=str)}
        if u.exported is not None:
            d["exported_json"] = json.dumps(u.exported, default=str)
        out.append(d)
    return out


def _field_desc(f: T.Field) -> dict:
    d = {"name": f.name, "type": type_descriptor(f.type),
         "documentation": f.doc, "deprecated": f.deprecated,
         "decorators": _dec_usages(f.decorators)}
    if f.tag is not None:
        d["tag"] = f.tag
    return d


def definition_descriptor(schema: Schema, name: str) -> dict:
    import json
    d = schema.definitions[name]
    out: dict = {"name": name, "fqn": schema.fqn(name),
                 "documentation": getattr(d, "doc", ""),
                 "visibility": 1 if getattr(d, "visibility", "export") == "local" else 0,
                 "decorators": _dec_usages(getattr(d, "decorators", None))}
    if isinstance(d, T.Enum):
        out["kind"] = 1
        out["enum_def"] = {
            "base": type_descriptor(d.base),
            "members": [{"name": m, "value": v} for m, v in d.members.items()],
        }
    elif isinstance(d, T.Struct):
        out["kind"] = 2
        out["struct_def"] = {"fields": [_field_desc(f) for f in d.fields],
                             "mutable": d.mutable}
    elif isinstance(d, T.Message):
        out["kind"] = 3
        out["message_def"] = {"fields": [_field_desc(f) for f in d.fields]}
    elif isinstance(d, T.Union):
        out["kind"] = 4
        out["union_def"] = {"branches": [
            {"name": b.name, "discriminator": b.discriminator,
             "type": type_descriptor(b.type)} for b in d.branches]}
    elif isinstance(d, ServiceDef):
        out["kind"] = 5
        out["service_def"] = {"methods": [
            {"name": m.name, "request": type_descriptor(m.request),
             "response": type_descriptor(m.response),
             "client_stream": m.client_stream,
             "server_stream": m.server_stream,
             "routing_id": m.id} for m in d.methods]}
    elif isinstance(d, ConstDef):
        out["kind"] = 6
        out["const_def"] = {"type": type_descriptor(d.type),
                            "value_json": json.dumps(d.value, default=str)}
    else:
        out["kind"] = 0
    return out


def _dependencies(d) -> List[str]:
    deps: List[str] = []

    def walk(t: T.Type):
        if isinstance(t, (T.Struct, T.Message, T.Union, T.Enum)):
            deps.append(t.name)
        elif isinstance(t, T.FixedArray) or isinstance(t, T.Array):
            walk(t.elem)
        elif isinstance(t, T.MapT):
            walk(t.key)
            walk(t.value)

    if isinstance(d, (T.Struct, T.Message)):
        for f in d.fields:
            walk(f.type)
    elif isinstance(d, T.Union):
        for b in d.branches:
            walk(b.type)
    elif isinstance(d, ServiceDef):
        for m in d.methods:
            walk(m.request)
            walk(m.response)
    elif isinstance(d, ConstDef):
        walk(d.type)
    return deps


def topological_order(schema: Schema) -> List[str]:
    """Dependencies before dependents (§6.3), stable w.r.t. source order."""
    out: List[str] = []
    done: set = set()
    visiting: set = set()

    def visit(name: str):
        if name in done or name not in schema.definitions:
            return
        if name in visiting:
            # recursive type (e.g. trees) — legal; break the cycle
            return
        visiting.add(name)
        for dep in _dependencies(schema.definitions[name]):
            if dep != name:
                visit(dep)
        visiting.discard(name)
        done.add(name)
        out.append(name)

    for name in schema.order:
        visit(name)
    return out


def schema_descriptor(schema: Schema) -> dict:
    return {"package": schema.package, "edition": schema.edition,
            "definitions": [definition_descriptor(schema, n)
                            for n in topological_order(schema)]}


def encode_descriptor_set(schemas: List[Schema]) -> bytes:
    """The descriptor, encoded with Bebop's own wire format (§6.3)."""
    value = {"schemas": [schema_descriptor(s) for s in schemas],
             "compiler_version": COMPILER_VERSION}
    return wire.encode(DescriptorSet, value)


def decode_descriptor_set(buf: bytes) -> dict:
    return wire.decode(DescriptorSet, buf)
