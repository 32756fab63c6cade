"""Status codes (0–16 aligned with gRPC) and the error that carries one.

Copied from the JAX package's ``core/rpc/status.py``: the page-level
``infer`` handler reports a bad request or an expired deadline with the
same codes the RPC service would put on the wire.
"""
from __future__ import annotations


class Status:
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16

    _NAMES = {}

    @classmethod
    def name(cls, code: int) -> str:
        if not cls._NAMES:
            cls._NAMES = {v: k for k, v in vars(cls).items()
                          if isinstance(v, int)}
        return cls._NAMES.get(code, f"APP_{code}")


class RpcError(Exception):
    def __init__(self, code: int, message: str = "", details: bytes = b""):
        super().__init__(f"[{Status.name(code)}] {message}")
        self.code = code
        self.message = message
        self.details = details
