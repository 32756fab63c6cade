"""Status codes: 0–16 aligned with gRPC, 17–255 application-defined (§7.8).

Copied from the JAX package's ``core/rpc/status.py``: both packages put the
same codes on the wire, and the same HTTP statuses on HTTP/1.1.
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
    # 17-255: application-defined

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


class TransportError(RpcError):
    """The connection died under a call: the bytes never (fully) made it.

    Always ``UNAVAILABLE``.  Distinct from a server-sent error frame so
    the resilient client can tell "the server said no" (not retryable)
    from "the wire failed" (reconnect, then retry idempotent work /
    resume streams from the cursor).
    """

    def __init__(self, message: str = "connection lost",
                 details: bytes = b""):
        super().__init__(Status.UNAVAILABLE, message, details)


class ClientTimeout(RpcError):
    """The client gave up waiting for a response frame.

    Always ``DEADLINE_EXCEEDED`` (matching the pre-existing wire-visible
    behavior), but typed: a local wait timeout means *unknown outcome* —
    the request may have been dropped in flight or may have executed and
    had its response lost — so it is only safe to retry under an
    idempotency key, which is exactly what ``ResilientChannel`` does.
    """

    def __init__(self, message: str = "client timeout"):
        super().__init__(Status.DEADLINE_EXCEEDED, message)


# gRPC status <-> HTTP status mapping for the HTTP/1.1 transport (§7.7).
HTTP_FROM_STATUS = {
    Status.OK: 200, Status.CANCELLED: 499, Status.UNKNOWN: 500,
    Status.INVALID_ARGUMENT: 400, Status.DEADLINE_EXCEEDED: 504,
    Status.NOT_FOUND: 404, Status.ALREADY_EXISTS: 409,
    Status.PERMISSION_DENIED: 403, Status.RESOURCE_EXHAUSTED: 429,
    Status.FAILED_PRECONDITION: 412, Status.ABORTED: 409,
    Status.OUT_OF_RANGE: 400, Status.UNIMPLEMENTED: 501,
    Status.INTERNAL: 500, Status.UNAVAILABLE: 503, Status.DATA_LOSS: 500,
    Status.UNAUTHENTICATED: 401,
}
