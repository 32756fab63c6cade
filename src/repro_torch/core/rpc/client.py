"""Client channel: multiplexed calls over one transport connection.

Copied unchanged from the JAX package's ``core/rpc/client.py``: it is JAX-free
host code, and both packages must put the same bytes on the wire.

Supports all four method types, batch pipelining, futures, cursors and
deadline propagation.  A background reader thread demultiplexes frames by
stream_id into per-call queues.

Two channel flavors:

  * ``Channel`` — one transport, fail-fast: when the connection dies (read
    loop error, framing desync, failed send) every pending and future call
    gets a typed ``TransportError`` immediately instead of blocking out
    its full timeout.
  * ``ResilientChannel`` — wraps a transport *factory*: reconnects with
    capped exponential backoff + jitter, retries unary calls under
    per-call idempotency keys (server dedups → exactly-once), and resumes
    server streams from the last delivered cursor across reconnects.
"""
from __future__ import annotations

import itertools
import queue
import random as _random
import threading
import time
import uuid as _uuid
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

from .. import wire
from ..retry import RetryPolicy
from ..schema import ServiceDef
from . import wire_types as W
from .deadline import Deadline
from .framing import Flags, Frame, FrameReader, encode_frame
from .status import ClientTimeout, RpcError, Status, TransportError
from .transport import Transport

#: metadata key carrying the per-call idempotency token (client-generated
#: UUID); the server's dedup cache keys on (client id, this value)
IDEMPOTENCY_KEY = "idempotency-key"
#: metadata key identifying one logical client across reconnects — the
#: TCP peer string changes every dial, this does not
CLIENT_ID_KEY = "rpc-client-id"


class StreamItem:
    """One server-stream element with its optional cursor (§7.5)."""

    __slots__ = ("payload", "cursor")

    def __init__(self, payload: bytes, cursor: Optional[int]):
        self.payload = payload
        self.cursor = cursor


class Channel:
    def __init__(self, transport: Transport, *,
                 metadata: Optional[Dict[str, str]] = None):
        self.transport = transport
        self.metadata = metadata or {}
        self._ids = itertools.count(1, 2)  # client streams are odd
        self._streams: Dict[int, queue.Queue] = {}
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._closed = False
        self._dead = False                 # guarded by _lock
        self._death = "connection closed"  # guarded by _lock
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="bebop-rpc-client-reader")
        self._reader.start()

    @property
    def alive(self) -> bool:
        return not (self._dead or self._closed)

    # -- plumbing -------------------------------------------------------------
    def _read_loop(self) -> None:
        reader = FrameReader()
        try:
            while not self._closed:
                data = self.transport.recv()
                if not data:
                    self._connection_lost("connection closed by peer"
                                          if not self._closed
                                          else "channel closed")
                    return
                for frame in reader.feed(data):
                    with self._lock:
                        q = self._streams.get(frame.stream_id)
                    if q is not None:
                        q.put(frame)
        except Exception as e:  # noqa: BLE001 - any reader death kills the conn
            # A desynced stream (FramingError) or a transport blow-up means
            # nothing further can be trusted: poison the connection and wake
            # every waiter NOW rather than letting them block out their
            # timeouts against a dead wire.
            self._connection_lost(f"read loop died: {e}")
            try:
                self.transport.close()
            except Exception:  # noqa: BLE001 - already tearing down
                pass

    def _connection_lost(self, why: str) -> None:
        """Mark the channel dead and wake every pending call immediately."""
        with self._lock:
            self._dead = True
            self._death = why
            waiters = list(self._streams.values())
        for q in waiters:
            q.put(None)

    def _new_stream(self) -> Tuple[int, queue.Queue]:
        sid = next(self._ids)
        q: queue.Queue = queue.Queue()
        with self._lock:
            if self._dead:
                raise TransportError(self._death)
            self._streams[sid] = q
        return sid, q

    def _finish(self, sid: int) -> None:
        with self._lock:
            self._streams.pop(sid, None)

    def _send(self, frame: Frame) -> None:
        try:
            with self._send_lock:
                self.transport.send(encode_frame(frame))
        except (ConnectionError, OSError) as e:
            self._connection_lost(f"send failed: {e}")
            raise TransportError(f"send failed: {e}") from e

    def _header_bytes(self, method_id: int, *,
                      deadline: Optional[Deadline],
                      metadata: Optional[Dict[str, str]],
                      cursor: int) -> bytes:
        h: dict = {"method_id": method_id}
        md = dict(self.metadata)
        if metadata:
            md.update(metadata)
        if md:
            h["metadata"] = md
        if deadline is not None:
            h["deadline"] = deadline.to_timestamp()
        if cursor:
            h["cursor"] = cursor
        return wire.encode(W.CallHeader, h)

    @staticmethod
    def _encode_request(request: Any) -> bytes:
        if request is None:
            return b""
        if isinstance(request, (bytes, bytearray, memoryview)):
            return bytes(request)
        if hasattr(request, "encode") and not isinstance(request, str):
            return request.encode()
        raise TypeError(f"cannot encode request of type {type(request)}")

    @staticmethod
    def _check_error(frame: Frame) -> None:
        if frame.error:
            err = wire.decode(W.ErrorPayload, frame.payload)
            raise RpcError(err.get("code", Status.UNKNOWN),
                           err.get("message", ""),
                           bytes(bytearray(err.get("details", b""))))

    # -- the four method types (§7.2) -------------------------------------------
    def call(self, method_id: int, request: Any = b"", *,
             client_stream: bool = False, server_stream: bool = False,
             deadline: Optional[Deadline] = None,
             metadata: Optional[Dict[str, str]] = None,
             cursor: int = 0, timeout: Optional[float] = 30.0):
        header = self._header_bytes(method_id, deadline=deadline,
                                    metadata=metadata, cursor=cursor)
        sid, q = self._new_stream()
        if client_stream:
            return self._client_stream_call(sid, q, header, request,
                                            server_stream, timeout)
        body = self._encode_request(request)
        self._send(Frame(sid, header + body, Flags.END_STREAM))
        if server_stream:
            return self._stream_iter(sid, q, timeout)
        return self._await_unary(sid, q, timeout)

    def _await_unary(self, sid: int, q: queue.Queue,
                     timeout: Optional[float]) -> bytes:
        try:
            frame = q.get(timeout=timeout)
            if frame is None:
                raise TransportError(self._death)
            self._check_error(frame)
            return frame.payload
        except queue.Empty:
            raise ClientTimeout(
                "client timeout waiting for response") from None
        finally:
            self._finish(sid)

    def _stream_iter(self, sid: int, q: queue.Queue,
                     timeout: Optional[float]) -> Iterator[StreamItem]:
        def gen():
            try:
                while True:
                    try:
                        frame = q.get(timeout=timeout)
                    except queue.Empty:
                        raise ClientTimeout(
                            "client timeout waiting for stream frame"
                        ) from None
                    if frame is None:
                        raise TransportError(self._death)
                    self._check_error(frame)
                    if frame.payload:
                        yield StreamItem(frame.payload, frame.cursor)
                    if frame.end_stream:
                        # the END frame's cursor (the server's final
                        # watermark) becomes the generator return value —
                        # ResilientChannel reads it via StopIteration to
                        # detect silently-lost tail frames; plain `for`
                        # loops never see it
                        return frame.cursor
            finally:
                self._finish(sid)
        return gen()

    def _client_stream_call(self, sid, q, header, requests,
                            server_stream: bool, timeout):
        first = True
        if requests is not None:
            for item in requests:
                body = self._encode_request(item)
                if first:
                    self._send(Frame(sid, header + body))
                    first = False
                else:
                    self._send(Frame(sid, body))
        if first:
            self._send(Frame(sid, header, Flags.END_STREAM))
        else:
            self._send(Frame(sid, b"", Flags.END_STREAM))
        if server_stream:
            return self._stream_iter(sid, q, timeout)
        return self._await_unary(sid, q, timeout)

    # -- batch pipelining (§7.3) --------------------------------------------------
    def batch(self, calls: List[dict], *,
              deadline: Optional[Deadline] = None,
              timeout: Optional[float] = 30.0) -> List[dict]:
        """One round trip for N (possibly dependent) calls.

        calls: [{"method_id": id, "payload": bytes, "input_from": -1}, ...]
        """
        norm = []
        for i, c in enumerate(calls):
            norm.append({
                "call_id": c.get("call_id", i),
                "method_id": c["method_id"],
                "payload": list(self._encode_request(c.get("payload", b""))),
                "input_from": c.get("input_from", -1),
            })
        req: dict = {"calls": norm}
        if deadline is not None:
            req["deadline"] = deadline.to_timestamp()
        out = self.call(W.METHOD_BATCH, wire.encode(W.BatchRequest, req),
                        deadline=deadline, timeout=timeout)
        res = wire.decode(W.BatchResponse, out)
        results = res.get("results", [])
        for r in results:
            if "payload" in r:
                r["payload"] = bytes(bytearray(r["payload"]))
            if "stream" in r:
                r["stream"] = [bytes(bytearray(x)) for x in r["stream"]]
        return results

    # -- futures (§7.6) -------------------------------------------------------------
    def dispatch_future(self, method_id: int, request: Any = b"", *,
                        batch: Optional[List[dict]] = None,
                        deadline: Optional[Deadline] = None,
                        idempotency_key: Optional[_uuid.UUID] = None,
                        discard_result: bool = False,
                        timeout: Optional[float] = 30.0) -> dict:
        req: dict = {"discard_result": discard_result}
        if batch is not None:
            req["batch"] = {"calls": [{
                "call_id": c.get("call_id", i),
                "method_id": c["method_id"],
                "payload": list(self._encode_request(c.get("payload", b""))),
                "input_from": c.get("input_from", -1)} for i, c in
                enumerate(batch)]}
        else:
            req["method_id"] = method_id
            req["payload"] = list(self._encode_request(request))
        if deadline is not None:
            req["deadline"] = deadline.to_timestamp()
        if idempotency_key is not None:
            req["idempotency_key"] = idempotency_key
        out = self.call(W.METHOD_FUTURE_DISPATCH,
                        wire.encode(W.FutureDispatchRequest, req),
                        timeout=timeout)
        return wire.decode(W.FutureHandle, out)

    def resolve_futures(self, ids: Optional[List[_uuid.UUID]] = None, *,
                        timeout: Optional[float] = 30.0) -> Iterator[dict]:
        req = {"ids": ids} if ids else {}
        stream = self.call(W.METHOD_FUTURE_RESOLVE,
                           wire.encode(W.FutureResolveRequest, req),
                           server_stream=True, timeout=timeout)
        for item in stream:
            res = wire.decode(W.FutureResult, item.payload)
            if "payload" in res:
                res["payload"] = bytes(bytearray(res["payload"]))
            yield res

    def cancel_future(self, fid: _uuid.UUID, *,
                      timeout: Optional[float] = 30.0) -> None:
        self.call(W.METHOD_FUTURE_CANCEL,
                  wire.encode(W.FutureCancelRequest, {"id": fid}),
                  timeout=timeout)

    # -- discovery ---------------------------------------------------------------------
    def discover(self, *, timeout: Optional[float] = 30.0) -> dict:
        out = self.call(W.METHOD_DISCOVER,
                        wire.encode(W.DiscoverRequest, {}), timeout=timeout)
        return wire.decode(W.DiscoverResponse, out)

    # -- typed helpers --------------------------------------------------------------
    def typed(self, svc: ServiceDef) -> "TypedClient":
        return TypedClient(self, svc)

    def close(self) -> None:
        self._closed = True
        self.transport.close()
        self._connection_lost("channel closed")


class ResilientChannel:
    """Reconnecting channel: ``Channel``'s call surface over a factory.

    The three recovery mechanisms (§7 robustness):

      * **Reconnect** — when the current connection is dead, dial
        ``transport_factory`` again under a shared :class:`RetryPolicy`
        (capped exponential backoff, jitter so a fleet of clients does
        not stampede back in lockstep).
      * **Idempotent unary retry** — every unary call carries a
        generated ``idempotency-key`` in metadata; the server caches the
        final response per (client id, key) and replays it, so retrying
        after an *unknown outcome* (timeout, connection lost mid-call)
        is exactly-once rather than at-least-once.
      * **Stream resume** — server-stream iterators remember the last
        delivered cursor and transparently re-issue the call with it
        after a reconnect; a monotonic-cursor filter drops anything the
        server re-sends below the watermark, so the consumer sees a
        gap-free, duplicate-free sequence.  Under the §7.5 discipline
        (cursor = count of items delivered) consecutive cursored frames
        advance by exactly 1, so a jump reveals a frame that was lost
        *without* killing the connection; the iterator then drops the
        lying connection and resumes from the watermark instead of
        silently skipping data (``strict_cursors=False`` disables this
        for servers whose cursors are not consecutive counters).

    Server-sent errors (ERROR frames) are never retried: the server
    answered, it just said no.  ``sleep`` and ``rng`` are injectable so
    tests run deterministically in zero wall-clock time.
    """

    RETRYABLE = (TransportError, ClientTimeout, ConnectionError, OSError)

    def __init__(self, transport_factory: Callable[[], Transport], *,
                 metadata: Optional[Dict[str, str]] = None,
                 policy: Optional[RetryPolicy] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[_random.Random] = None,
                 strict_cursors: bool = True):
        self._factory = transport_factory
        self._strict_cursors = strict_cursors
        self._policy = policy or RetryPolicy(
            attempts=6, base_delay=0.05, multiplier=2.0, max_delay=1.0,
            jitter=0.25, retry_on=self.RETRYABLE)
        self.client_id = str(_uuid.uuid4())
        self.metadata = dict(metadata or {})
        self.metadata.setdefault(CLIENT_ID_KEY, self.client_id)
        self._sleep = sleep
        self._rng = rng or _random.Random()
        self._lock = threading.Lock()
        self._channel: Optional[Channel] = None  # guarded by _lock
        self._closed = False  # guarded by _lock
        self.reconnects = 0   # successful dials beyond the first; guarded by _lock
        self.retries = 0      # unary attempts beyond each call's first
        self.gaps = 0         # cursor jumps: frames lost on a live conn

    # -- connection management ------------------------------------------------
    def channel(self) -> Channel:
        """The live channel, dialing (with backoff) if the last one died."""
        with self._lock:
            if self._closed:
                raise TransportError("resilient channel closed")
            ch = self._channel
            if ch is not None and ch.alive:
                return ch
        p = self._policy
        last: Optional[BaseException] = None
        for attempt in range(max(p.attempts, 1)):
            with self._lock:
                if self._closed:
                    raise TransportError("resilient channel closed")
                ch = self._channel
                if ch is not None and ch.alive:
                    return ch  # another thread won the dial race
            try:
                fresh = Channel(self._factory(), metadata=self.metadata)
            except Exception as e:  # noqa: BLE001 - filtered right below
                if not p.retryable(e):
                    raise
                last = e
                if attempt < p.attempts - 1:
                    self._sleep(p.delay(attempt + 1, self._rng))
                continue
            with self._lock:
                stale, live = self._channel, None
                if stale is not None and stale.alive:
                    live = stale          # lost the race; keep theirs
                else:
                    self._channel = fresh
                    if stale is not None:
                        self.reconnects += 1
            if live is not None:
                fresh.close()
                return live
            if stale is not None:
                stale.close()
            return fresh
        raise TransportError(
            f"reconnect failed after {p.attempts} attempts: {last}")

    def _drop_channel(self) -> None:
        """Discard the current channel so the next call re-dials."""
        with self._lock:
            ch, self._channel = self._channel, None
        if ch is not None:
            ch.close()

    # -- calls ----------------------------------------------------------------
    def call(self, method_id: int, request: Any = b"", *,
             client_stream: bool = False, server_stream: bool = False,
             deadline: Optional[Deadline] = None,
             metadata: Optional[Dict[str, str]] = None,
             cursor: int = 0, timeout: Optional[float] = 30.0):
        if server_stream:
            return self._resilient_stream(method_id, request, client_stream,
                                          deadline, metadata, cursor, timeout)
        if client_stream:
            # A half-sent client stream is not safely replayable as a unit
            # (the request generator is consumed); no transparent retry.
            return self.channel().call(
                method_id, request, client_stream=True, deadline=deadline,
                metadata=metadata, cursor=cursor, timeout=timeout)
        md = dict(metadata or {})
        md.setdefault(IDEMPOTENCY_KEY, str(_uuid.uuid4()))
        p = self._policy
        for attempt in range(max(p.attempts, 1)):
            try:
                return self.channel().call(
                    method_id, request, deadline=deadline, metadata=md,
                    cursor=cursor, timeout=timeout)
            except self.RETRYABLE:
                if attempt == p.attempts - 1:
                    raise
                if deadline is not None and deadline.expired():
                    raise
                self.retries += 1
                self._sleep(p.delay(attempt + 1, self._rng))

    def _resilient_stream(self, method_id: int, request: Any,
                          client_stream: bool, deadline: Optional[Deadline],
                          metadata: Optional[Dict[str, str]],
                          start_cursor: int, timeout: Optional[float]
                          ) -> Iterator[StreamItem]:
        def gen():
            watermark = start_cursor
            uncursored = 0    # items delivered that carried no cursor
            failures = 0      # consecutive, reset by progress
            p = self._policy
            while True:
                gap = False
                try:
                    items = iter(self.channel().call(
                        method_id, request, client_stream=client_stream,
                        server_stream=True, deadline=deadline,
                        metadata=metadata, cursor=watermark, timeout=timeout))
                    while True:
                        try:
                            item = next(items)
                        except StopIteration as stop:
                            # clean END: the END frame's cursor is the
                            # server's final watermark — if ours is behind
                            # it, the tail frame(s) were silently lost
                            end_cursor = stop.value
                            if self._strict_cursors \
                                    and end_cursor is not None \
                                    and end_cursor > watermark:
                                gap = True
                                self.gaps += 1
                            break
                        if item.cursor is not None:
                            if item.cursor <= watermark:
                                continue  # replayed prefix: already delivered
                            if self._strict_cursors \
                                    and item.cursor != watermark + 1:
                                # a cursored frame vanished without killing
                                # the connection (silent drop): refuse the
                                # out-of-order item, drop the lying channel
                                # and resume from the watermark
                                gap = True
                                self.gaps += 1
                                break
                            watermark = item.cursor
                        else:
                            uncursored += 1
                        failures = 0
                        yield item
                    if not gap:
                        return
                except self.RETRYABLE as e:
                    if uncursored:
                        # Delivered items we cannot name a resume point for:
                        # replaying would duplicate them.  Surface the fault.
                        raise TransportError(
                            f"stream not resumable ({uncursored} items "
                            f"delivered without cursors): {e}") from e
                    failures += 1
                    if failures >= p.attempts:
                        raise
                    self._sleep(p.delay(failures, self._rng))
                    continue
                # gap: the connection delivered past a lost frame — close
                # it (stopping the server-side stream) and resume
                self._drop_channel()
                failures += 1
                if failures >= p.attempts:
                    raise TransportError(
                        f"stream gave up after {failures} consecutive "
                        f"cursor gaps (watermark {watermark})")
                self._sleep(p.delay(failures, self._rng))
        return gen()

    # -- observability --------------------------------------------------------
    def collect_stats(self) -> Dict[str, int]:
        """Resilience counters, stable key set (dashboards/routers poll
        this alongside the server's Stats RPC)."""
        return {"reconnects": self.reconnects, "retries": self.retries,
                "gaps": self.gaps}

    # -- parity helpers (same surface as Channel) -----------------------------
    def typed(self, svc: ServiceDef) -> "TypedClient":
        return TypedClient(self, svc)

    def discover(self, *, timeout: Optional[float] = 30.0) -> dict:
        out = self.call(W.METHOD_DISCOVER,
                        wire.encode(W.DiscoverRequest, {}), timeout=timeout)
        return wire.decode(W.DiscoverResponse, out)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            ch, self._channel = self._channel, None
        if ch is not None:
            ch.close()


class TypedClient:
    """Encode/decode wrapper around a channel for one service definition.

    Works over a plain ``Channel`` or a ``ResilientChannel`` — it only
    uses ``.call``, which both expose with the same signature.
    """

    def __init__(self, channel: "Channel | ResilientChannel",
                 svc: ServiceDef):
        self._channel = channel
        self._svc = svc
        for m in svc.methods:
            setattr(self, m.name, self._make(m))

    def _make(self, m):
        ch = self._channel

        def unary(request: Any, **kw):
            out = ch.call(m.id, wire.encode(m.request, request), **kw)
            return wire.decode(m.response, out)

        def sstream(request: Any, **kw):
            for item in ch.call(m.id, wire.encode(m.request, request),
                                server_stream=True, **kw):
                yield wire.decode(m.response, item.payload)

        def cstream(requests: Iterable[Any], **kw):
            out = ch.call(m.id,
                          (wire.encode(m.request, r) for r in requests),
                          client_stream=True, **kw)
            return wire.decode(m.response, out)

        def duplex(requests: Iterable[Any], **kw):
            for item in ch.call(m.id,
                                (wire.encode(m.request, r) for r in requests),
                                client_stream=True, server_stream=True, **kw):
                yield wire.decode(m.response, item.payload)

        return {"unary": unary, "server_stream": sstream,
                "client_stream": cstream, "duplex": duplex}[m.kind]
