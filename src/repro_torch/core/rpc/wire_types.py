"""Protocol message types — every layer of the protocol is Bebop (§7.1).

Copied unchanged from the JAX package's ``core/rpc/wire_types.py``: it is JAX-free
host code, and both packages must put the same bytes on the wire.

"An implementation that can decode Bebop messages can decode every part of
the protocol": call headers, error payloads, metadata, the batch protocol,
futures, and service discovery responses are all ordinary Bebop messages
defined here with the schema DSL.
"""
from __future__ import annotations

from .. import types as T

# -- call setup --------------------------------------------------------------

CallHeader = T.Message("CallHeader", [
    T.Field("method_id", T.UINT32, tag=1),       # murmur3+lowbias32 (§7.2)
    T.Field("deadline", T.TIMESTAMP, tag=2),     # absolute, ns precision (§7.4)
    T.Field("metadata", T.MapT(T.STRING, T.STRING), tag=3),
    T.Field("cursor", T.UINT64, tag=4),          # resume point (§7.5)
])

ErrorPayload = T.Message("ErrorPayload", [
    T.Field("code", T.UINT8, tag=1),             # Status, 0-16 gRPC-aligned
    T.Field("message", T.STRING, tag=2),
    T.Field("details", T.Array(T.BYTE), tag=3),
])

Empty = T.Struct("Empty", [])

# -- batch pipelining (§7.3) -------------------------------------------------

BatchCall = T.Message("BatchCall", [
    T.Field("call_id", T.INT32, tag=1),
    T.Field("method_id", T.UINT32, tag=2),
    T.Field("payload", T.Array(T.BYTE), tag=3),
    T.Field("input_from", T.INT32, tag=4),   # -1 = own payload, >=0 = forward
])

BatchRequest = T.Message("BatchRequest", [
    T.Field("calls", T.Array(BatchCall), tag=1),
    T.Field("deadline", T.TIMESTAMP, tag=2),
])

BatchCallResult = T.Message("BatchCallResult", [
    T.Field("call_id", T.INT32, tag=1),
    T.Field("status", T.UINT8, tag=2),
    T.Field("payload", T.Array(T.BYTE), tag=3),      # unary result
    T.Field("stream", T.Array(T.Array(T.BYTE)), tag=4),  # buffered stream (§7.3)
    T.Field("error", T.STRING, tag=5),
])

BatchResponse = T.Message("BatchResponse", [
    T.Field("results", T.Array(BatchCallResult), tag=1),
])

# -- futures (§7.6) -----------------------------------------------------------

FutureDispatchRequest = T.Message("FutureDispatchRequest", [
    T.Field("method_id", T.UINT32, tag=1),       # inner unary call
    T.Field("payload", T.Array(T.BYTE), tag=2),
    T.Field("batch", BatchRequest, tag=3),       # OR a whole batch
    T.Field("deadline", T.TIMESTAMP, tag=4),     # applies to the inner call
    T.Field("idempotency_key", T.UUID, tag=5),   # client-generated (§7.6.1)
    T.Field("discard_result", T.BOOL, tag=6),    # fire-and-forget (§7.6.2)
])

FutureHandle = T.Message("FutureHandle", [
    T.Field("id", T.UUID, tag=1),                # server-generated v4 UUID
    T.Field("existing", T.BOOL, tag=2),          # deduped by idempotency key
])

FutureResolveRequest = T.Message("FutureResolveRequest", [
    T.Field("ids", T.Array(T.UUID), tag=1),      # empty = all owned futures
])

FutureResult = T.Message("FutureResult", [
    T.Field("id", T.UUID, tag=1),
    T.Field("status", T.UINT8, tag=2),
    T.Field("payload", T.Array(T.BYTE), tag=3),
    T.Field("error", T.STRING, tag=4),
    T.Field("metadata", T.MapT(T.STRING, T.STRING), tag=5),
])

FutureCancelRequest = T.Message("FutureCancelRequest", [
    T.Field("id", T.UUID, tag=1),
])

# -- service discovery --------------------------------------------------------

DiscoverRequest = T.Message("DiscoverRequest", [
    T.Field("service", T.STRING, tag=1),         # empty = all
])

MethodInfo = T.Message("MethodInfo", [
    T.Field("service", T.STRING, tag=1),
    T.Field("name", T.STRING, tag=2),
    T.Field("routing_id", T.UINT32, tag=3),
    T.Field("kind", T.STRING, tag=4),
])

DiscoverResponse = T.Message("DiscoverResponse", [
    T.Field("methods", T.Array(MethodInfo), tag=1),
    T.Field("descriptor", T.Array(T.BYTE), tag=2),  # DescriptorSet bytes
])

# -- reserved method IDs (§7.6) ------------------------------------------------

METHOD_BATCH = 1
METHOD_FUTURE_DISPATCH = 2
METHOD_FUTURE_RESOLVE = 3
METHOD_FUTURE_CANCEL = 4
METHOD_DISCOVER = 5

RESERVED_METHOD_IDS = frozenset({
    METHOD_BATCH, METHOD_FUTURE_DISPATCH, METHOD_FUTURE_RESOLVE,
    METHOD_FUTURE_CANCEL, METHOD_DISCOVER,
})
