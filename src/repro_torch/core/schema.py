"""RPC service definitions: :class:`MethodDef` and :class:`ServiceDef`.

Copied from the JAX package's ``core/schema.py``, trimmed to the two
classes the RPC server, the client and the inference service use (the
schema container, constants and decorator definitions belong to the
schema compiler, which the port does not carry).  A method's routing id is
``method_id(service, method)``, the same 32 bits in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from . import types as T
from .hashing import method_id


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
