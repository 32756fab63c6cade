"""RPC status codes; the RPC stack itself is not ported yet."""
from .status import RpcError, Status  # noqa: F401
