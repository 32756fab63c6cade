"""Transports (§7.7): the protocol is transport-agnostic.

Copied from the JAX package's ``core/rpc/transport.py``, trimmed to the two
transports the server and client use:

  * InMemoryTransport — queue pair with injectable one-way latency, used by
    tests (latency is what batch pipelining amortizes).
  * TcpTransport — the binary framing directly over a socket.

All transports expose the same byte-stream interface; the frame layer on
top never knows which one it runs over.
"""
from __future__ import annotations

import queue
import socket
import time
from typing import Optional, Tuple


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
