"""Bebop RPC (paper §7): transport-agnostic, Bebop-encoded at every layer.

Copied from the JAX package's ``core/rpc`` (JAX-free host code): frames,
deadlines, the server with batch pipelining, futures and dedup, the plain
and resilient clients, and the in-memory, TCP, HTTP/1.1 and
fault-injecting transports.  Both packages speak the
same bytes, so a client of either talks to a server of either.
"""
from .status import (Status, RpcError, TransportError,      # noqa: F401
                     ClientTimeout)
from .framing import (Frame, Flags, encode_frame,           # noqa: F401
                      FrameReader, FramingError)
from .deadline import Deadline                              # noqa: F401
from .server import (Router, RpcContext, Server,            # noqa: F401
                     ConnectionState, DedupCache)
from .client import (Channel, ResilientChannel,             # noqa: F401
                     IDEMPOTENCY_KEY, CLIENT_ID_KEY)
from .transport import (InMemoryTransport, TcpTransport,    # noqa: F401
                        Http1Transport, connected_pair,
                        FaultSpec, FaultInjectingTransport)
