"""Server side: integer-dispatch router + frame loop (§7.2).

Copied from the JAX package's ``core/rpc/server.py``: it is JAX-free host
code, and both packages must put the same bytes on the wire.  The port adds
its spans (``utils/spans.py``): ``rpc.queued`` and ``rpc.handler``.

The router maps 32-bit method IDs to handlers — integer comparison, no
string matching.  Reserved IDs implement the framework-level protocols:
1=Batch, 2=FutureDispatch, 3=FutureResolve (server-stream), 4=FutureCancel,
5=Discover.

Robustness surfaces (failure model in docs/ARCHITECTURE.md):

  * per-connection isolation — a desynced or hostile byte stream kills
    its own connection, never the accept loop or sibling connections;
  * ``ConnectionState`` — handlers register on-close hooks via
    ``ctx.conn`` so resources pinned by a caller (KV blocks, decode
    loops) are reclaimed the moment the caller's connection dies;
  * ``DedupCache`` — unary calls carrying an idempotency key execute at
    most once per (client id, key); retries replay the cached response,
    giving ``ResilientChannel`` exactly-once semantics over a lossy wire;
  * ``drain()`` — stop accepting new work (except exempt methods, e.g.
    health checks), finish what is in flight, then close the listeners.
"""
from __future__ import annotations

import collections
import concurrent.futures as _cf
import socket as _socket
import threading
from typing import Any, Callable, Dict, List, Optional, Set

from ...utils import spans
from .. import types as T
from .. import wire
from ..schema import ServiceDef
from . import wire_types as W
from .batch import execute_batch
from .client import CLIENT_ID_KEY, IDEMPOTENCY_KEY
from .deadline import Deadline
from .framing import Flags, Frame, FrameReader, encode_frame
from .futures import FutureManager
from .status import RpcError, Status
from .transport import Transport


class ConnectionState:
    """Liveness of one client connection, visible to handlers as ``ctx.conn``.

    Handlers that pin server resources on behalf of a caller (KV blocks,
    a decode loop feeding a stream) register a hook with ``on_close``;
    the serve loop fires every hook exactly once when the connection
    ends, however it ends.  Registering on an already-closed connection
    fires the hook immediately.
    """

    def __init__(self, peer: str = "unknown"):
        self.peer = peer
        self._lock = threading.Lock()
        self._hooks: List[Callable[[], None]] = []  # guarded by _lock
        self._closed = False                        # guarded by _lock

    @property
    def closed(self) -> bool:
        return self._closed

    def on_close(self, hook: Callable[[], None]) -> Callable[[], None]:
        """Register ``hook`` to run at connection close; returns it."""
        fire = False
        with self._lock:
            if self._closed:
                fire = True
            else:
                self._hooks.append(hook)
        if fire:
            hook()
        return hook

    def discard(self, hook: Callable[[], None]) -> None:
        """Unregister a hook (for calls that completed normally)."""
        with self._lock:
            try:
                self._hooks.remove(hook)
            except ValueError:
                pass

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            hooks, self._hooks = self._hooks, []
        for hook in hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 - teardown must not cascade
                pass


class _DedupEntry:
    __slots__ = ("ready", "payload", "flags", "cursor")

    def __init__(self):
        self.ready = threading.Event()
        self.payload = b""
        self.flags = Flags.END_STREAM
        self.cursor: Optional[int] = None


class DedupCache:
    """At-most-once execution for idempotency-keyed unary calls.

    The first arrival of a key owns execution; its final response frame
    (success or error) is cached and every retry — concurrent or later —
    replays it instead of re-running the handler.  Keys are scoped by
    client id, so two clients picking the same UUID cannot collide.
    Bounded LRU: a retry can only arrive within its call's (bounded)
    retry window, so old entries are safe to evict.
    """

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, _DedupEntry]" = \
            collections.OrderedDict()
        self.hits = 0       # guarded by _lock
        self.evictions = 0  # guarded by _lock

    def begin(self, key: str):
        """-> ("mine"|"wait"|"done", entry): own it, or join the first try."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = _DedupEntry()
                self._entries[key] = e
                while len(self._entries) > self.max_entries:
                    oldest = next(iter(self._entries))
                    if not self._entries[oldest].ready.is_set():
                        break  # never evict an execution in progress
                    del self._entries[oldest]
                    self.evictions += 1
                return "mine", e
            self._entries.move_to_end(key)
            self.hits += 1
            return ("done" if e.ready.is_set() else "wait"), e

    def finish(self, entry: _DedupEntry, payload: bytes, flags: int,
               cursor: Optional[int]) -> None:
        """Record the final frame; first final frame wins, then idempotent."""
        if entry.ready.is_set():
            return
        entry.payload = payload
        entry.flags = flags
        entry.cursor = cursor
        entry.ready.set()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class RpcContext:
    """Per-call context: metadata, deadline, cursor, peer identity (§7.4-7.6)."""

    def __init__(self, *, metadata: Optional[Dict[str, str]] = None,
                 deadline: Optional[Deadline] = None, cursor: int = 0,
                 peer: str = "local",
                 conn: Optional[ConnectionState] = None):
        self.metadata = metadata or {}
        self.deadline = deadline
        self.cursor = cursor
        self.peer = peer
        self.conn = conn if conn is not None else ConnectionState(peer)
        self._next_cursor: Optional[int] = None
        self.last_cursor: Optional[int] = None  # high-water mark ever set

    # caller identity: authenticated identity if present, else peer (§7.6.1)
    @property
    def caller(self) -> str:
        return self.metadata.get("authorization", self.peer)

    def check_deadline(self) -> None:
        if self.deadline is not None and self.deadline.expired():
            raise RpcError(Status.DEADLINE_EXCEEDED, "deadline expired")

    def set_cursor(self, value: int) -> None:
        """Attach a position marker to the next emitted stream frame (§7.5)."""
        self._next_cursor = value
        self.last_cursor = value

    def take_cursor(self) -> Optional[int]:
        c = self._next_cursor
        self._next_cursor = None
        return c


class _Method:
    __slots__ = ("id", "name", "kind", "request_type", "response_type", "fn",
                 "service")

    def __init__(self, mid, name, kind, req_t, res_t, fn, service=""):
        self.id = mid
        self.name = name
        self.kind = kind
        self.request_type = req_t
        self.response_type = res_t
        self.fn = fn
        self.service = service


class Router:
    """method_id -> handler.  Integer dispatch (§7.2)."""

    def __init__(self):
        self._methods: Dict[int, _Method] = {}

    def register_handler(self, method_id: int, fn: Callable, *,
                         name: str = "", kind: str = "unary",
                         request_type: Optional[T.Type] = None,
                         response_type: Optional[T.Type] = None,
                         service: str = "") -> None:
        if method_id in self._methods:
            raise T.SchemaError(f"method id collision: {method_id:#x}")
        if method_id in W.RESERVED_METHOD_IDS:
            raise T.SchemaError(f"method id {method_id} is reserved")
        self._methods[method_id] = _Method(method_id, name, kind,
                                           request_type, response_type, fn,
                                           service)

    def add_service(self, svc: ServiceDef, impl: Any) -> None:
        for m in svc.methods:
            fn = getattr(impl, m.name, None)
            if fn is None:
                raise T.SchemaError(
                    f"implementation missing method {svc.name}.{m.name}")
            self.register_handler(m.id, fn, name=m.name, kind=m.kind,
                                  request_type=m.request,
                                  response_type=m.response, service=svc.name)

    def lookup(self, method_id: int) -> _Method:
        m = self._methods.get(method_id)  # integer compare, no strings
        if m is None:
            raise RpcError(Status.UNIMPLEMENTED,
                           f"unknown method {method_id:#010x}")
        return m

    def method_kinds(self) -> Dict[int, str]:
        return {mid: m.kind for mid, m in self._methods.items()}

    def methods(self):
        return list(self._methods.values())

    # raw invoke used by the batch engine and futures: bytes -> bytes
    def invoke_raw(self, method_id: int, payload: bytes, ctx: RpcContext):
        m = self.lookup(method_id)
        req = wire.decode(m.request_type, payload) \
            if m.request_type is not None else payload
        if m.kind == "server_stream":
            def gen():
                for item in m.fn(req, ctx):
                    yield wire.encode(m.response_type, item) \
                        if m.response_type is not None else bytes(item)
            return gen()
        out = m.fn(req, ctx)
        if m.response_type is not None:
            return wire.encode(m.response_type, out)
        return bytes(out) if out is not None else b""


class Server:
    """Frame loop over any transport; one thread per connection."""

    def __init__(self, router: Router, *,
                 futures: Optional[FutureManager] = None,
                 descriptor: bytes = b"",
                 max_workers: int = 16,
                 dedup: Optional[DedupCache] = None):
        self.router = router
        self.futures = futures or FutureManager()
        self.descriptor = descriptor
        self.pool = _cf.ThreadPoolExecutor(max_workers=max_workers)
        self._client_streams: Dict[int, "._StreamSink"] = {}
        self.dedup = dedup or DedupCache()
        #: method ids still answered while draining (health/stats probes)
        self.drain_exempt: Set[int] = set()
        self._draining = False
        self._inflight = 0  # guarded by _flight_cv
        self._flight_cv = threading.Condition()
        self._conn_lock = threading.Lock()
        self._conns: Set[Transport] = set()
        self._listen_socks: List[Any] = []
        self.conn_errors = 0  # connections torn down by framing/transport error

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def inflight(self) -> int:
        with self._flight_cv:
            return self._inflight

    def _submit_tracked(self, fn, *args, method: str = "") -> None:
        """Run a handler on the pool, counted for ``drain()``.  With spans
        on, the call gets a request id: its wait for a pool thread is
        ``rpc.queued``, its run there ``rpc.handler``."""
        with self._flight_cv:
            self._inflight += 1
        queued = spans.now() if spans.on else 0

        def run():
            try:
                if queued:
                    rid = spans.new_request()
                    spans.add("rpc.queued", queued, request=rid,
                              method=method)
                    with spans.scope("rpc.handler", rid, method=method):
                        fn(*args)
                else:
                    fn(*args)
            finally:
                with self._flight_cv:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._flight_cv.notify_all()
        self.pool.submit(run)

    # -- frame-level entry (binary transports) -------------------------------
    def serve_transport(self, transport: Transport, *,
                        blocking: bool = True) -> Optional[threading.Thread]:
        if not blocking:
            t = threading.Thread(target=self.serve_transport,
                                 args=(transport,), daemon=True,
                                 name="bebop-rpc-conn")
            t.start()
            return t
        reader = FrameReader()
        sinks: Dict[int, _StreamSink] = {}
        send_lock = threading.Lock()
        conn = ConnectionState(transport.peer)
        with self._conn_lock:
            self._conns.add(transport)

        def send(frame: Frame) -> None:
            with send_lock:
                transport.send(encode_frame(frame))

        # Per-connection isolation: whatever this byte stream does — clean
        # close, desync (FramingError), transport blow-up — the damage stays
        # on this connection.  The finally block fires the close hooks so
        # everything the caller pinned (KV blocks, decode loops) is
        # reclaimed promptly, and wakes client-stream handlers.
        try:
            while True:
                data = transport.recv()
                if not data:
                    return None
                for frame in reader.feed(data):
                    sink = sinks.get(frame.stream_id)
                    if sink is None:
                        sink = self._open_stream(frame, send, transport.peer,
                                                 conn)
                        if sink is not None:
                            sinks[frame.stream_id] = sink
                    else:
                        sink.push(frame.payload if frame.payload else None)
                        if frame.end_stream:
                            sink.push(None)
                    if frame.end_stream and frame.stream_id in sinks \
                            and sinks[frame.stream_id].done:
                        del sinks[frame.stream_id]
        except Exception:  # noqa: BLE001 - isolation: this conn only
            self.conn_errors += 1
            return None
        finally:
            with self._conn_lock:
                self._conns.discard(transport)
            try:
                transport.close()
            except Exception:  # noqa: BLE001 - already tearing down
                pass
            conn.close()
            for s in sinks.values():
                s.push(None)

    def _open_stream(self, frame: Frame, send, peer: str,
                     conn: Optional[ConnectionState] = None):
        """First frame of a stream: CallHeader + request payload."""
        try:
            header, off = wire.decode_with_end(W.CallHeader, frame.payload)
        except T.BebopError as e:
            self._send_error(send, frame.stream_id,
                             RpcError(Status.INVALID_ARGUMENT,
                                      f"bad call header: {e}"))
            return None
        body = frame.payload[off:]
        deadline = None
        if "deadline" in header:
            deadline = Deadline.from_timestamp(header["deadline"])
        ctx = RpcContext(metadata=header.get("metadata", {}),
                         deadline=deadline,
                         cursor=header.get("cursor", 0), peer=peer,
                         conn=conn)
        mid = header.get("method_id", 0)
        if self._draining and mid not in self.drain_exempt:
            self._send_error(send, frame.stream_id,
                             RpcError(Status.UNAVAILABLE, "server draining"))
            return None
        # reserved framework methods
        if mid in W.RESERVED_METHOD_IDS:
            self._submit_tracked(self._run_reserved, mid, body, ctx, send,
                                 frame.stream_id)
            return None
        try:
            m = self.router.lookup(mid)
        except RpcError as e:
            self._send_error(send, frame.stream_id, e)
            return None
        if m.kind in ("client_stream", "duplex"):
            sink = _StreamSink()
            if body:
                sink.push(body)
            if frame.end_stream:
                sink.push(None)
            self._submit_tracked(self._run_streaming_in, m, sink, ctx, send,
                                 frame.stream_id, method=m.name)
            return sink
        if m.kind == "unary":
            key = self._dedup_key(ctx)
            if key is not None:
                state, entry = self.dedup.begin(key)
                if state == "done":
                    self._submit_tracked(self._replay_dedup, entry, send,
                                         frame.stream_id, method=m.name)
                    return None
                if state == "wait":
                    self._submit_tracked(self._join_dedup, entry, send,
                                         frame.stream_id, method=m.name)
                    return None
                send = self._capturing_send(entry, send)
        self._submit_tracked(self._run_single, m, body, ctx, send,
                             frame.stream_id, method=m.name)
        return None

    # -- idempotency (exactly-once unary execution) ---------------------------
    @staticmethod
    def _dedup_key(ctx: RpcContext) -> Optional[str]:
        key = ctx.metadata.get(IDEMPOTENCY_KEY)
        if not key:
            return None
        return f"{ctx.metadata.get(CLIENT_ID_KEY, ctx.peer)}\x00{key}"

    def _capturing_send(self, entry: _DedupEntry, send):
        """Wrap ``send`` to cache the final frame before it hits the wire.

        Capture happens first, so a response lost to a dying connection is
        still cached and the retry replays it — that is the whole point.
        """
        def capturing(frame: Frame) -> None:
            if frame.flags & Flags.END_STREAM:
                self.dedup.finish(entry, frame.payload, frame.flags,
                                  frame.cursor)
            send(frame)
        return capturing

    def _replay_dedup(self, entry: _DedupEntry, send, stream_id: int) -> None:
        try:
            send(Frame(stream_id, entry.payload, entry.flags, entry.cursor))
        except (ConnectionError, OSError):
            pass  # caller gone again; the cache still holds the response

    def _join_dedup(self, entry: _DedupEntry, send, stream_id: int) -> None:
        """A retry raced the original execution: wait for it, replay it."""
        if not entry.ready.wait(timeout=300.0):
            self._send_error(send, stream_id,
                             RpcError(Status.DEADLINE_EXCEEDED,
                                      "first attempt still running"))
            return
        self._replay_dedup(entry, send, stream_id)

    # -- handler execution ---------------------------------------------------
    def _run_single(self, m: _Method, body: bytes, ctx: RpcContext, send,
                    stream_id: int) -> None:
        try:
            ctx.check_deadline()
            req = wire.decode(m.request_type, body) \
                if m.request_type is not None else body
            if m.kind == "server_stream":
                for item in m.fn(req, ctx):
                    payload = wire.encode(m.response_type, item) \
                        if m.response_type is not None else bytes(item)
                    send(Frame(stream_id, payload, cursor=ctx.take_cursor()))
                # the END frame repeats the final cursor: a client that
                # silently lost the last data frame(s) can tell the stream
                # is short and resume instead of reporting a clean end
                send(Frame(stream_id, b"", Flags.END_STREAM,
                           cursor=ctx.last_cursor))
                return
            out = m.fn(req, ctx)
            payload = wire.encode(m.response_type, out) \
                if m.response_type is not None else (bytes(out or b""))
            send(Frame(stream_id, payload, Flags.END_STREAM,
                       cursor=ctx.take_cursor()))
        except RpcError as e:
            self._send_error(send, stream_id, e)
        except Exception as e:  # noqa: BLE001
            self._send_error(send, stream_id, RpcError(Status.INTERNAL,
                                                       str(e)))

    def _run_streaming_in(self, m: _Method, sink: "_StreamSink",
                          ctx: RpcContext, send, stream_id: int) -> None:
        def req_iter():
            while True:
                item = sink.pop()
                if item is None:
                    return
                yield (wire.decode(m.request_type, item)
                       if m.request_type is not None else item)
        try:
            ctx.check_deadline()
            if m.kind == "duplex":
                for item in m.fn(req_iter(), ctx):
                    payload = wire.encode(m.response_type, item) \
                        if m.response_type is not None else bytes(item)
                    send(Frame(stream_id, payload, cursor=ctx.take_cursor()))
                send(Frame(stream_id, b"", Flags.END_STREAM,
                           cursor=ctx.last_cursor))
            else:  # client_stream -> single response
                out = m.fn(req_iter(), ctx)
                payload = wire.encode(m.response_type, out) \
                    if m.response_type is not None else bytes(out or b"")
                send(Frame(stream_id, payload, Flags.END_STREAM))
        except RpcError as e:
            self._send_error(send, stream_id, e)
        except Exception as e:  # noqa: BLE001
            self._send_error(send, stream_id,
                             RpcError(Status.INTERNAL, str(e)))
        finally:
            sink.done = True

    # -- reserved framework methods -------------------------------------------
    def _run_reserved(self, mid: int, body: bytes, ctx: RpcContext, send,
                      stream_id: int) -> None:
        try:
            if mid == W.METHOD_BATCH:
                req = wire.decode(W.BatchRequest, body)
                deadline = ctx.deadline
                if "deadline" in req:
                    deadline = Deadline.from_timestamp(req["deadline"])
                results = execute_batch(
                    req.get("calls", []),
                    lambda m_id, payload, c: self.router.invoke_raw(
                        m_id, payload, c),
                    deadline=deadline, ctx=ctx, executor=self.pool,
                    method_kinds=self.router.method_kinds())
                out = wire.encode(W.BatchResponse, {"results": results})
                send(Frame(stream_id, out, Flags.END_STREAM))
            elif mid == W.METHOD_FUTURE_DISPATCH:
                req = wire.decode(W.FutureDispatchRequest, body)
                handle = self._dispatch_future(req, ctx)
                send(Frame(stream_id, wire.encode(W.FutureHandle, handle),
                           Flags.END_STREAM))
            elif mid == W.METHOD_FUTURE_RESOLVE:
                req = wire.decode(W.FutureResolveRequest, body)
                for res in self.futures.resolve(ctx.caller,
                                                req.get("ids") or None):
                    send(Frame(stream_id,
                               wire.encode(W.FutureResult, res)))
                send(Frame(stream_id, b"", Flags.END_STREAM))
            elif mid == W.METHOD_FUTURE_CANCEL:
                req = wire.decode(W.FutureCancelRequest, body)
                self.futures.cancel(ctx.caller, req["id"])
                send(Frame(stream_id, wire.encode(W.Empty, {}),
                           Flags.END_STREAM))
            elif mid == W.METHOD_DISCOVER:
                methods = [{"service": m.service, "name": m.name,
                            "routing_id": m.id, "kind": m.kind}
                           for m in self.router.methods()]
                out = wire.encode(W.DiscoverResponse, {
                    "methods": methods,
                    "descriptor": list(self.descriptor)})
                send(Frame(stream_id, out, Flags.END_STREAM))
        except RpcError as e:
            self._send_error(send, stream_id, e)
        except Exception as e:  # noqa: BLE001
            self._send_error(send, stream_id,
                             RpcError(Status.INTERNAL, str(e)))

    def _dispatch_future(self, req: dict, ctx: RpcContext) -> dict:
        deadline = None
        if "deadline" in req:
            deadline = Deadline.from_timestamp(req["deadline"])
        inner_ctx = RpcContext(metadata=ctx.metadata, deadline=deadline,
                               peer=ctx.peer)
        if "batch" in req:
            batch = req["batch"]

            def run() -> bytes:
                results = execute_batch(
                    batch.get("calls", []),
                    lambda m_id, payload, c: self.router.invoke_raw(
                        m_id, payload, c),
                    deadline=deadline, ctx=inner_ctx, executor=self.pool,
                    method_kinds=self.router.method_kinds())
                return wire.encode(W.BatchResponse, {"results": results})
        else:
            mid = req.get("method_id", 0)
            payload = bytes(req.get("payload", b""))

            def run() -> bytes:
                # the inner handler can't tell it runs as a future (§7.6)
                return self.router.invoke_raw(mid, payload, inner_ctx)

        fid, existing = self.futures.dispatch(
            ctx.caller, run,
            idempotency_key=req.get("idempotency_key"),
            deadline=deadline,
            discard_result=req.get("discard_result", False))
        return {"id": fid, "existing": existing}

    @staticmethod
    def _send_error(send, stream_id: int, e: RpcError) -> None:
        """Best-effort: the caller may already be gone; never cascade."""
        payload = wire.encode(W.ErrorPayload, {
            "code": e.code, "message": e.message,
            "details": list(e.details)})
        try:
            send(Frame(stream_id, payload, Flags.ERROR | Flags.END_STREAM))
        except (ConnectionError, OSError):
            pass

    # -- graceful drain --------------------------------------------------------
    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop accepting new work, finish what is in flight, close up.

        New calls (except ``drain_exempt`` method ids — health probes) are
        refused with UNAVAILABLE the moment this is called.  Returns True
        if everything in flight completed within ``timeout``; either way
        the listeners and remaining connections are closed on exit.
        """
        self._draining = True
        with self._flight_cv:
            done = self._flight_cv.wait_for(lambda: self._inflight == 0,
                                            timeout=timeout)
        for lsock in self._listen_socks:
            # shutdown wakes the accept thread: close alone leaves it blocked
            # in accept() (Linux), holding the server and its handlers
            for end in (lambda: lsock.shutdown(_socket.SHUT_RDWR),
                        lsock.close):
                try:
                    end()
                except OSError:
                    pass
        self._listen_socks.clear()
        with self._conn_lock:
            conns = list(self._conns)
        for t in conns:
            try:
                t.close()
            except Exception:  # noqa: BLE001 - already tearing down
                pass
        return done

    # -- TCP convenience -------------------------------------------------------
    def listen_tcp(self, host: str = "127.0.0.1", port: int = 0):
        """Bind + serve in background threads.  Returns (host, port, sock)."""
        from .transport import TcpTransport
        lsock = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        lsock.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        lsock.bind((host, port))
        lsock.listen(64)
        self._listen_socks.append(lsock)

        def accept_loop():
            while True:
                try:
                    conn, _ = lsock.accept()
                except OSError:
                    return
                self.serve_transport(TcpTransport(conn), blocking=False)

        t = threading.Thread(target=accept_loop, daemon=True,
                             name="bebop-rpc-accept")
        t.start()
        return lsock.getsockname()[0], lsock.getsockname()[1], lsock


class _StreamSink:
    """Queue of inbound payloads for client-stream/duplex methods."""

    def __init__(self):
        import queue as _q
        self._q = _q.Queue()
        self.done = False

    def push(self, item) -> None:
        self._q.put(item)

    def pop(self):
        return self._q.get()
