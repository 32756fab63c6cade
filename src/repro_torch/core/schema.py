"""Schema object model: definitions, services, constants, whole-schema container.

`types.py` holds the wire *type* nodes; this module holds everything a `.bop`
file can declare around them (§5): services with streaming methods and `with`
composition, typed constants, decorator definitions, packages/imports, and the
`Schema` container the compiler produces.

Copied from the JAX package's ``core/schema.py``: the RPC
server, the client and the inference service use :class:`MethodDef` and
:class:`ServiceDef`; the schema compiler the rest.  A method's routing id
is ``method_id(service, method)``, the same 32 bits in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from . import types as T
from .hashing import method_id

# Re-export the DSL surface so users can
# `from repro_torch.core.schema import *`.
from .types import (  # noqa: F401
    Array, BOOL, BYTE, BFLOAT16, Branch, DecoratorUsage, DURATION, Duration,
    Enum, Field, FixedArray, FLOAT16, FLOAT32, FLOAT64, INT128, INT16, INT32,
    INT64, INT8, MapT, Message, Prim, STRING, Struct, TIMESTAMP, Timestamp,
    Type, UINT128, UINT16, UINT32, UINT64, UINT8, UUID, Union, UnionValue,
    SchemaError,
)


@dataclasses.dataclass
class MethodDef:
    name: str
    request: T.Type
    response: T.Type
    client_stream: bool = False
    server_stream: bool = False
    doc: str = ""
    decorators: List[T.DecoratorUsage] = dataclasses.field(default_factory=list)
    # Filled when the method is attached to a service.
    service: Optional[str] = None
    id: Optional[int] = None

    @property
    def kind(self) -> str:
        if self.client_stream and self.server_stream:
            return "duplex"
        if self.client_stream:
            return "client_stream"
        if self.server_stream:
            return "server_stream"
        return "unary"


class ServiceDef:
    """RPC interface (§5.10).  `with` composition copies methods in."""

    def __init__(self, name: str, methods: Sequence[MethodDef], *,
                 extends: Sequence["ServiceDef"] = (), doc: str = "",
                 visibility: str = "export",
                 decorators: Optional[List[T.DecoratorUsage]] = None):
        self.name = name
        self.doc = doc
        self.visibility = visibility
        self.decorators = decorators or []
        self.methods: List[MethodDef] = []
        seen = set()
        for base in extends:
            for m in base.methods:
                self._add(dataclasses.replace(m), seen)
        for m in methods:
            self._add(m, seen)

    def _add(self, m: MethodDef, seen: set) -> None:
        if m.name in seen:
            raise T.SchemaError(
                f"duplicate method {m.name} in service {self.name}")
        if not isinstance(m.request, (T.Struct, T.Message, T.Union)):
            raise T.SchemaError(
                f"{self.name}.{m.name}: request must be a named "
                f"struct/message/union, got {m.request!r}")
        if not isinstance(m.response, (T.Struct, T.Message, T.Union)):
            raise T.SchemaError(
                f"{self.name}.{m.name}: response must be a named "
                f"struct/message/union, got {m.response!r}")
        m.service = self.name
        m.id = method_id(self.name, m.name)
        seen.add(m.name)
        self.methods.append(m)

    def method(self, name: str) -> MethodDef:
        for m in self.methods:
            if m.name == name:
                return m
        raise KeyError(name)


@dataclasses.dataclass
class ConstDef:
    name: str
    type: T.Type
    value: object
    doc: str = ""
    visibility: str = "export"


@dataclasses.dataclass
class DecoratorParam:
    name: str
    type_name: str
    required: bool


@dataclasses.dataclass
class DecoratorDef:
    """`#decorator(name) { targets=...; param...; validate [[..]]; export [[..]] }`"""

    name: str
    targets: List[str]
    params: List[DecoratorParam]
    validate_src: Optional[str] = None
    export_src: Optional[str] = None
    doc: str = ""

    def param(self, name: str) -> Optional[DecoratorParam]:
        for p in self.params:
            if p.name == name:
                return p
        return None


VALID_TARGETS = {"ENUM", "STRUCT", "MESSAGE", "UNION", "FIELD", "SERVICE",
                 "METHOD", "BRANCH", "ALL"}


class Schema:
    """Everything one `.bop` compilation produced."""

    def __init__(self, *, package: str = "", edition: str = "2026"):
        self.package = package
        self.edition = edition
        self.definitions: Dict[str, object] = {}   # name -> type/service/const
        self.order: List[str] = []                 # topological
        self.decorator_defs: Dict[str, DecoratorDef] = {}
        self.imports: List[str] = []

    # -- registration ------------------------------------------------------
    def add(self, defn) -> None:
        name = defn.name
        if name in self.definitions:
            raise T.SchemaError(f"duplicate definition {name}")
        self.definitions[name] = defn
        self.order.append(name)

    def add_decorator(self, d: DecoratorDef) -> None:
        if d.name in self.decorator_defs:
            raise T.SchemaError(f"duplicate decorator {d.name}")
        for t in d.targets:
            if t not in VALID_TARGETS:
                raise T.SchemaError(f"invalid decorator target {t}")
        self.decorator_defs[d.name] = d

    # -- lookup ------------------------------------------------------------
    def __getitem__(self, name: str):
        return self.definitions[name]

    def get(self, name: str, default=None):
        return self.definitions.get(name, default)

    def types(self) -> Dict[str, T.Type]:
        return {k: v for k, v in self.definitions.items()
                if isinstance(v, T.Type)}

    def services(self) -> Dict[str, ServiceDef]:
        return {k: v for k, v in self.definitions.items()
                if isinstance(v, ServiceDef)}

    def constants(self) -> Dict[str, ConstDef]:
        return {k: v for k, v in self.definitions.items()
                if isinstance(v, ConstDef)}

    def fqn(self, name: str) -> str:
        return f"{self.package}.{name}" if self.package else name
