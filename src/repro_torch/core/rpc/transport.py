"""Transports (§7.7): the protocol is transport-agnostic.

Three concrete transports ship here:

  * InMemoryTransport — queue pair with injectable one-way latency, used by
    tests and by the batch-pipelining RTT benchmark (latency actually
    matters there: it is what batching amortizes).
  * TcpTransport — the binary framing directly over a socket.
  * Http1Transport — request/response mapping for HTTP/1.1-only platforms
    (§7.7: serverless, workers, browsers).  Metadata maps to headers, the
    deadline to ``bebop-deadline``, errors to HTTP status codes; the body
    carries Bebop frames, so streaming responses arrive as consecutive
    frames in the response body.

All transports expose the same byte-stream interface; the frame layer on
top never knows which one it runs over.  :class:`FaultInjectingTransport`
wraps any of them in seeded, frame-granular faults for the chaos tests.

Copied unchanged from the JAX package's ``core/rpc/transport.py``: it is
JAX-free host code, and both packages must put the same bytes on the wire
(HTTP envelopes, and the damage a fault seed injects, included).
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import random as _random
import socket
import time
from typing import Dict, Optional, Tuple

from .framing import HEADER_SIZE, FramingError
from .status import HTTP_FROM_STATUS


class Transport:
    def send(self, data: bytes) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> bytes:
        """Blocking read; returns b"" when the peer closed."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def peer(self) -> str:
        return "unknown"


class InMemoryTransport(Transport):
    """One endpoint of an in-memory duplex pipe with simulated latency."""

    def __init__(self, rx: "queue.Queue", tx: "queue.Queue",
                 latency: float = 0.0, name: str = "mem"):
        self._rx = rx
        self._tx = tx
        self.latency = latency
        self._name = name
        self._closed = False
        self.bytes_sent = 0
        self.messages_sent = 0

    def send(self, data: bytes) -> None:
        if self._closed:
            raise ConnectionError("transport closed")
        self.bytes_sent += len(data)
        self.messages_sent += 1
        self._tx.put((time.monotonic() + self.latency, data))

    def recv(self, timeout: Optional[float] = None) -> bytes:
        try:
            ready_at, data = self._rx.get(timeout=timeout)
        except queue.Empty:
            return b""
        wait = ready_at - time.monotonic()
        if wait > 0:
            time.sleep(wait)  # latency injection: delivery time honored
        return data

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._tx.put((time.monotonic(), b""))

    @property
    def peer(self) -> str:
        return self._name


def connected_pair(latency: float = 0.0
                   ) -> Tuple[InMemoryTransport, InMemoryTransport]:
    """(client, server) in-memory transports with one-way ``latency`` sec."""
    a_to_b: queue.Queue = queue.Queue()
    b_to_a: queue.Queue = queue.Queue()
    client = InMemoryTransport(b_to_a, a_to_b, latency, "mem-client")
    server = InMemoryTransport(a_to_b, b_to_a, latency, "mem-server")
    return client, server


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-frame fault rates for :class:`FaultInjectingTransport`.

    Each ``send()`` (one frame on both the client and server paths) draws
    once from a seeded RNG and suffers at most one fault, checked in
    order: disconnect, drop, truncate, corrupt, delay.  Rates are
    absolute probabilities, so their sum must stay <= 1.
    """

    drop: float = 0.0        # silently discard the frame
    truncate: float = 0.0    # deliver a strict prefix, then cut the line
    corrupt: float = 0.0     # damage the frame header, then cut the line
    disconnect: float = 0.0  # cut the line instead of sending
    delay: float = 0.0       # deliver late
    delay_s: float = 0.01    # how late

    def __post_init__(self):
        total = (self.drop + self.truncate + self.corrupt
                 + self.disconnect + self.delay)
        if total > 1.0:
            raise ValueError(f"fault rates sum to {total} > 1")


class FaultInjectingTransport(Transport):
    """Deterministic (seeded) chaos wrapper around any transport.

    The serving-side counterpart of ``train/fault.py``: every resilience
    mechanism in the RPC stack is tested against this harness.  Faults
    are injected on the *send* path — wrap both endpoints of a pair to
    fault both directions — at frame granularity (each ``Channel``/
    ``Server`` send carries exactly one frame).

    Two fault kinds deliver damaged bytes (``truncate``, ``corrupt``)
    and both poison the connection immediately afterwards, the way a
    real desynced stream ends in a reset: the peer sees the damage (or a
    stall) and then a clean close, exercising its framing validation and
    reconnect paths without ever parsing unbounded garbage.  ``corrupt``
    sets a high bit of the frame-length field, so the damage is always
    detectable — either an impossible length (FramingError) or a frame
    the peer waits on until the close lands.  Payload bit rot is
    deliberately out of scope: integrity inside a delivered frame is the
    transport's contract (TCP/TLS checksums), as in the paper's
    protocol.

    ``script`` pins faults to exact send indices (0-based) for
    regression tests; scripted faults fire regardless of rates.
    """

    def __init__(self, inner: Transport, spec: FaultSpec = FaultSpec(), *,
                 seed: int = 0, script: Optional[Dict[int, str]] = None):
        self.inner = inner
        self.spec = spec
        self._rng = _random.Random(seed)
        self._script = dict(script or {})
        self._sends = 0
        self._broken = False
        self.injected: collections.Counter = collections.Counter()

    # -- fault selection -----------------------------------------------------
    def _pick_fault(self) -> Optional[str]:
        idx = self._sends
        self._sends += 1
        if idx in self._script:
            return self._script[idx]
        r = self._rng.random()
        s = self.spec
        for name, rate in (("disconnect", s.disconnect), ("drop", s.drop),
                           ("truncate", s.truncate), ("corrupt", s.corrupt),
                           ("delay", s.delay)):
            if r < rate:
                return name
            r -= rate
        return None

    def _cut(self) -> None:
        self._broken = True
        self.inner.close()

    # -- transport interface -------------------------------------------------
    def send(self, data: bytes) -> None:
        if self._broken:
            raise ConnectionError("transport closed (injected fault)")
        fault = self._pick_fault()
        if fault is None:
            self.inner.send(data)
            return
        self.injected[fault] += 1
        if fault == "disconnect":
            self._cut()
            raise ConnectionError("injected fault: disconnect")
        if fault == "drop":
            return
        if fault == "truncate":
            cut = self._rng.randrange(1, len(data)) if len(data) > 1 else 0
            if cut:
                self.inner.send(data[:cut])
            self._cut()
            raise ConnectionError("injected fault: truncate")
        if fault == "corrupt":
            bad = bytearray(data)
            if len(bad) >= HEADER_SIZE:
                # set a high bit of the little-endian u32 length field:
                # the parsed length jumps by >= 2^24, which is always an
                # impossible frame — deterministically detectable
                bad[3] |= 0x80
            else:
                bad = bytearray(b"\xff" * HEADER_SIZE)
            self.inner.send(bytes(bad))
            self._cut()
            raise ConnectionError("injected fault: corrupt")
        if fault == "delay":
            time.sleep(self.spec.delay_s)
            self.inner.send(data)

    def recv(self, timeout: Optional[float] = None) -> bytes:
        if self._broken:
            return b""
        return self.inner.recv(timeout)

    def close(self) -> None:
        self._broken = True
        self.inner.close()

    @property
    def peer(self) -> str:
        return f"chaos({self.inner.peer})"


class TcpTransport(Transport):
    """Binary frames directly over TCP (§7.2 'binary transports')."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            self._peer = "%s:%d" % self._sock.getpeername()[:2]
        except OSError:
            self._peer = "tcp"

    @classmethod
    def connect(cls, host: str, port: int, timeout: float = 5.0
                ) -> "TcpTransport":
        s = socket.create_connection((host, port), timeout=timeout)
        s.settimeout(None)
        return cls(s)

    def send(self, data: bytes) -> None:
        self._sock.sendall(data)

    def recv(self, timeout: Optional[float] = None) -> bytes:
        self._sock.settimeout(timeout)
        try:
            return self._sock.recv(65536)
        except socket.timeout:
            return b""
        except OSError:
            return b""

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    @property
    def peer(self) -> str:
        return self._peer


class Http1Transport(Transport):
    """HTTP/1.1 mapping: one POST per call, frames in the body (§7.7).

    The client side builds ``POST /bebop HTTP/1.1`` requests whose body is
    the call's frames; the server side answers with the response frames in
    the body.  Errors surface both as the ERROR frame *and* the HTTP status
    code so plain HTTP infrastructure (load balancers, API gateways) can see
    failures.  No HTTP/2, no trailers, no proxies.
    """

    #: reject bodies larger than this before buffering them (a corrupted
    #: or hostile Content-Length must not make us allocate unboundedly)
    MAX_BODY = 1 << 26  # 64 MiB, matches framing.MAX_FRAME_PAYLOAD

    def __init__(self, inner: Transport, *, client: bool,
                 max_body: Optional[int] = None):
        self.inner = inner
        self.is_client = client
        self.max_body = self.MAX_BODY if max_body is None else max_body
        self._buf = bytearray()

    # -- client --------------------------------------------------------------
    def send(self, data: bytes) -> None:
        if self.is_client:
            head = (b"POST /bebop HTTP/1.1\r\n"
                    b"content-type: application/bebop\r\n"
                    b"content-length: " + str(len(data)).encode() + b"\r\n"
                    b"\r\n")
            self.inner.send(head + data)
        else:
            status = 200
            head = ("HTTP/1.1 %d %s\r\n"
                    "content-type: application/bebop\r\n"
                    "content-length: %d\r\n\r\n"
                    % (status, "OK", len(data))).encode()
            self.inner.send(head + data)

    def send_error(self, code: int, body: bytes = b"") -> None:
        http = HTTP_FROM_STATUS.get(code, 500)
        head = ("HTTP/1.1 %d Error\r\n"
                "content-type: application/bebop\r\n"
                "bebop-status: %d\r\n"
                "content-length: %d\r\n\r\n" % (http, code, len(body))
                ).encode()
        self.inner.send(head + body)

    # -- shared --------------------------------------------------------------
    def recv(self, timeout: Optional[float] = None) -> bytes:
        """Strip one HTTP envelope, return its body (the Bebop frames)."""
        while True:
            sep = self._buf.find(b"\r\n\r\n")
            if sep != -1:
                head = bytes(self._buf[:sep]).decode("latin-1")
                clen = 0
                for line in head.split("\r\n")[1:]:
                    k, _, v = line.partition(":")
                    if k.strip().lower() == "content-length":
                        try:
                            clen = int(v.strip())
                        except ValueError:
                            raise FramingError(
                                f"unparseable content-length {v.strip()!r}")
                if clen < 0 or clen > self.max_body:
                    raise FramingError(
                        f"content-length {clen} outside [0, {self.max_body}]")
                body_start = sep + 4
                if len(self._buf) >= body_start + clen:
                    body = bytes(self._buf[body_start:body_start + clen])
                    del self._buf[:body_start + clen]
                    return body
            if sep == -1 and len(self._buf) > 65536:
                raise FramingError("HTTP header exceeds 64 KiB")
            data = self.inner.recv(timeout)
            if not data:
                return b""
            self._buf += data

    def close(self) -> None:
        self.inner.close()

    @property
    def peer(self) -> str:
        return self.inner.peer
