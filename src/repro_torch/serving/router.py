"""Replica router: the Bebop-RPC front door over N engine replicas.

A port of the JAX package's ``serving/router.py``: the router is host code
that proxies request bytes, so the copy differs only in what it imports
(the port's service, pages, wire and RPC stack) and in what an
:class:`InProcessReplica` shares (the port's :class:`Engine`: its weights on
the card and its loaded kernels).  Both routers speak the same bytes, so
either fronts replicas of either package.

One engine process is a single point of failure: a crash kills every
in-flight stream and a slow process drags the whole tail.  This module
composes the single-connection primitives (ResilientChannel,
idempotency-keyed dedup, cursor-resumable streams, Health/drain) into a
replicated serving tier:

  * **health-gated routing** — a poller thread per replica issues
    ``Health(verbose=True)`` probes; drain state, remote inflight and
    queue depth feed a per-replica load score, and a failed probe gates
    the replica out until it answers again;
  * **circuit breakers** — consecutive transport failures open a
    per-replica breaker (closed -> open -> half-open single probe), so a
    dead replica stops eating attempts while it is down;
  * **failover** — unary calls are resubmitted to a surviving replica
    under a router-generated idempotency key (the replica's DedupCache
    absorbs duplicate attempts: exactly-once per replica), and server
    streams are re-issued from the router's delivered-cursor watermark
    (generation is deterministic, so the resumed tail is token-identical
    and the watermark filter makes delivery gap/dup-free);
  * **hedged requests** — per The Tail at Scale: an ``Infer`` still
    unanswered after the observed latency quantile fires a second,
    *unkeyed* attempt on another replica; the first response wins and the
    loser's channel is closed, which triggers the replica's
    cancel-on-disconnect hook so the abandoned attempt returns its KV
    blocks instead of decoding for nobody;
  * **prefix affinity** — a consistent hash (vnode ring) over the
    prompt's leading block-aligned tokens routes shared prefixes to the
    same replica, keeping the per-replica prefix caches hot;
  * **epoch guard** — replicas stamp a per-process epoch in Health and
    in every stream chunk; a mid-stream epoch change means a
    ResilientChannel silently resumed into a *restarted* process, so the
    router rejects that delivery and explicitly re-issues from its own
    watermark instead of trusting a cursor the fresh process never saw.

The router is itself a Bebop-RPC server speaking the same
``InferenceService`` — clients cannot tell it from a single engine.  Its
own ``Server``-level DedupCache keeps client-keyed retries exactly-once
end to end; request payloads are forwarded as raw bytes (no re-encode on
the proxy path).  That opacity is why schema growth is free here: the
sampling fields (``temperature``/``top_k``/``top_p``/``seed``/``n``,
serving/sampling.py:GenerationParams) ride through byte-identically
with no router change — ``_affinity_key`` decodes only the leading
prompt tokens, and every trailing field is replica business.
``Stats``/``Health`` are answered locally with router and per-replica
counters.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import hashlib
import itertools
import queue as _queue
import random as _random
import threading
import time
import uuid as _uuid
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core import pages, wire
from ..core.retry import RetryPolicy
from ..core.rpc import (Channel, IDEMPOTENCY_KEY, ResilientChannel, Router,
                        RpcContext, RpcError, Server, Status, TransportError)
from ..core.rpc.transport import Transport, connected_pair
from .service import (DRAIN_EXEMPT_METHODS, HealthRequest, HealthResponse,
                      InferenceImpl, InferenceService, InferRequest,
                      build_server)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Routing knobs; every field has a ``launch/serve.py`` flag."""

    hedge: bool = True             # hedge Infer after the latency quantile
    hedge_delay_ms: float = 50.0   # fallback delay before history exists
    hedge_quantile: float = 0.95   # observed-latency quantile that arms it
    breaker_threshold: int = 3     # consecutive failures -> open
    breaker_reset_s: float = 5.0   # open -> half-open probe after this long
    affinity_prefix: int = 64      # leading prompt tokens hashed (0 = off)
    affinity_block: int = 16       # tokens rounded down to this multiple
    health_interval_s: float = 1.0  # poll period (0 = poll manually)
    health_timeout_s: float = 2.0
    attempt_timeout_s: float = 30.0
    max_attempts: int = 3          # unary tries: 1 + failovers, <= replicas
    stream_attempts: int = 6       # stream (re)issues before giving up
    vnodes: int = 64               # ring points per replica
    #: per-replica channel policy: snappier than the client default so a
    #: dead replica fails over in tens of ms instead of riding out six
    #: in-place reconnect attempts
    policy: RetryPolicy = RetryPolicy(
        attempts=2, base_delay=0.02, multiplier=2.0, max_delay=0.2,
        jitter=0.25, retry_on=ResilientChannel.RETRYABLE)


class CircuitBreaker:
    """closed -> open on N consecutive failures -> half-open single probe.

    ``allow()`` is the consuming check at dispatch time: in the open
    state it returns True exactly once per reset window (that caller IS
    the half-open probe); ``ready()`` is the pure view used for health
    reporting and candidate filtering.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 3, reset_after: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = max(1, threshold)
        self.reset_after = reset_after
        self._clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED   # guarded by _lock
        self.failures = 0          # consecutive, reset by any success; guarded by _lock
        self.opens = 0             # times the breaker tripped open; guarded by _lock
        self._opened_at = 0.0      # guarded by _lock

    def ready(self) -> bool:
        """Pure: could a call be admitted right now?"""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                return self._clock() - self._opened_at >= self.reset_after
            return False  # half-open: the single probe is already out

    def allow(self) -> bool:
        """Consuming: admit this call?  May transition open -> half-open."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN and \
                    self._clock() - self._opened_at >= self.reset_after:
                self.state = self.HALF_OPEN  # this caller is the probe
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self.state = self.CLOSED
            self.failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == self.HALF_OPEN \
                    or self.failures >= self.threshold:
                if self.state != self.OPEN:
                    self.opens += 1
                self.state = self.OPEN
                self._opened_at = self._clock()


class Replica:
    """Router-side view of one engine replica behind a dial function."""

    def __init__(self, name: str, dial: Callable[[], Transport],
                 cfg: RouterConfig, *,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[_random.Random] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.dial = dial
        self.channel = ResilientChannel(dial, policy=cfg.policy,
                                        sleep=sleep, rng=rng)
        self.breaker = CircuitBreaker(cfg.breaker_threshold,
                                      cfg.breaker_reset_s, clock)
        self.poll_ok = True        # optimistic until the first probe lands
        self.draining = False
        self.remote_inflight = 0   # from Health
        self.queue_depth = 0.0     # from Health verbose gauges
        self.epoch: Optional[int] = None  # last seen process epoch
        self.inflight = 0          # router-side outstanding attempts
        self.latencies: collections.deque = collections.deque(maxlen=128)
        self._lock = threading.Lock()

    def routable(self) -> bool:
        return self.poll_ok and not self.draining and self.breaker.ready()

    def load(self) -> float:
        """Lower is better; router-side inflight weighs double because it
        is the freshest signal (Health data ages a poll interval)."""
        return 2.0 * self.inflight + self.remote_inflight + self.queue_depth

    def observe(self, seconds: float) -> None:
        self.latencies.append(seconds)

    def track(self) -> "._Track":
        return _Track(self)


class _Track:
    __slots__ = ("r",)

    def __init__(self, r: Replica):
        self.r = r

    def __enter__(self):
        with self.r._lock:
            self.r.inflight += 1
        return self

    def __exit__(self, *exc):
        with self.r._lock:
            self.r.inflight -= 1
        return False


class _Failover(Exception):
    """Internal: this attempt failed in a way worth resubmitting."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


class _EpochChanged(Exception):
    """Internal: a stream silently resumed into a restarted process."""


class ReplicaRouter:
    """The routing brain; ``build_router_server`` wraps it in a Server."""

    RETRYABLE = ResilientChannel.RETRYABLE

    def __init__(self, replicas: Sequence, config: Optional[RouterConfig]
                 = None, *,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[_random.Random] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = config or RouterConfig()
        self._sleep = sleep
        self._rng = rng or _random.Random()
        self._clock = clock
        self.epoch = time.time_ns()  # the router is a process too
        self.replicas: List[Replica] = []
        for i, r in enumerate(replicas):
            if isinstance(r, Replica):
                self.replicas.append(r)
            elif callable(r):
                self.replicas.append(Replica(f"replica{i}", r, self.cfg,
                                             sleep=sleep, rng=rng,
                                             clock=clock))
            elif hasattr(r, "dial"):  # e.g. InProcessReplica
                self.replicas.append(Replica(
                    getattr(r, "name", f"replica{i}"), r.dial, self.cfg,
                    sleep=sleep, rng=rng, clock=clock))
            else:
                raise TypeError(f"not a replica or dial function: {r!r}")
        if not self.replicas:
            raise ValueError("router needs at least one replica")
        # consistent-hash ring: vnodes per replica, sorted once
        ring: List[Tuple[int, int]] = []
        for i, r in enumerate(self.replicas):
            for v in range(self.cfg.vnodes):
                h = hashlib.blake2b(f"{r.name}#{v}".encode(),
                                    digest_size=8).digest()
                ring.append((int.from_bytes(h, "big"), i))
        ring.sort()
        self._ring = ring
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, float] = {
            "requests": 0, "failovers": 0, "stream_failovers": 0,
            "hedges_fired": 0, "hedges_won": 0, "hedges_cancelled": 0,
            "epoch_rejections": 0, "epoch_changes": 0,
            "no_replica_errors": 0, "health_polls": 0,
            "health_poll_failures": 0,
        }
        self._health_id = InferenceService.method("Health").id
        self._server: Optional[Server] = None
        self._stop = threading.Event()
        self._pollers: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def attach_server(self, server: Server) -> None:
        self._server = server
        server.drain_exempt |= DRAIN_EXEMPT_METHODS

    def start(self) -> None:
        """Start one poller thread per replica (no-op if interval <= 0)."""
        if self.cfg.health_interval_s <= 0 or self._pollers:
            return
        for r in self.replicas:
            t = threading.Thread(target=self._poll_loop, args=(r,),
                                 daemon=True, name=f"router-poll-{r.name}")
            self._pollers.append(t)
            t.start()

    def close(self) -> None:
        self._stop.set()
        for r in self.replicas:
            r.channel.close()

    # -- health polling ------------------------------------------------------
    def _poll_loop(self, r: Replica) -> None:
        # each replica gets its own thread so one slow or dead replica
        # cannot stall the probes that keep the others routable
        while not self._stop.wait(self.cfg.health_interval_s):
            self.poll(r)

    def poll(self, replica: Optional[Replica] = None) -> None:
        """One probe round (tests drive this directly with interval=0)."""
        for r in ([replica] if replica is not None else self.replicas):
            self._poll_once(r)

    def _poll_once(self, r: Replica) -> None:
        try:
            ch = Channel(r.dial())
        except Exception:  # noqa: BLE001 - any dial failure gates it out
            r.poll_ok = False
            self._bump("health_poll_failures")
            return
        try:
            raw = ch.call(self._health_id,
                          wire.encode(HealthRequest, {"verbose": True}),
                          timeout=self.cfg.health_timeout_s)
            h = wire.decode(HealthResponse, raw)
        except Exception:  # noqa: BLE001 - failed probe = not routable
            r.poll_ok = False
            self._bump("health_poll_failures")
            return
        finally:
            ch.close()
        self._bump("health_polls")
        r.poll_ok = True
        r.draining = bool(h.get("draining"))
        r.remote_inflight = int(h.get("inflight", 0))
        ep = h.get("epoch")
        if ep is not None:
            if r.epoch is not None and ep != r.epoch:
                self._bump("epoch_changes")
                r.latencies.clear()  # a fresh process has fresh latency
            r.epoch = ep
        names = h.get("names", "")
        if names:
            gauges = dict(zip(names.split("\n"),
                              np.asarray(h.get("values", []), np.float64)))
            r.queue_depth = float(gauges.get("queued_requests", 0.0))

    # -- replica selection ---------------------------------------------------
    def _ring_order(self, key: bytes) -> Iterator[Replica]:
        h = int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                           "big")
        start = bisect.bisect_left(self._ring, (h, -1))
        seen: set = set()
        n = len(self._ring)
        for k in range(n):
            _, idx = self._ring[(start + k) % n]
            if idx not in seen:
                seen.add(idx)
                yield self.replicas[idx]

    def _pick(self, *, affinity: Optional[bytes] = None,
              exclude: Sequence[Replica] = ()) -> Optional[Replica]:
        cands = [r for r in self.replicas
                 if r not in exclude and r.routable()]
        if not cands:
            return None
        if affinity is not None:
            # ring order IS the fallback chain: the same prefix always
            # walks the same replica sequence, so failover stays sticky
            for r in self._ring_order(affinity):
                if r in cands and r.breaker.allow():
                    return r
            return None
        for r in sorted(cands, key=lambda r: r.load()):
            if r.breaker.allow():
                return r
        return None

    def _affinity_key(self, body: bytes) -> Optional[bytes]:
        """Leading block-aligned prompt tokens of an InferRequest page."""
        k = self.cfg.affinity_prefix
        if k <= 0 or len(self.replicas) <= 1:
            return None
        try:
            req = wire.decode(InferRequest, body)
            page = req.get("page")
            if page is None or len(page) == 0:
                return None
            buf = page if isinstance(page, (bytes, bytearray, memoryview)) \
                else bytes(bytearray(page))
            payload = pages.read_payload(buf)
            row = np.ascontiguousarray(payload[0]).view("<u4")
            n = (min(k, row.shape[0]) // self.cfg.affinity_block
                 * self.cfg.affinity_block)
            if n == 0:
                return None
            return row[:n].tobytes()
        except Exception:  # noqa: BLE001 - malformed page: route by load,
            return None    # let the replica produce the real error

    # -- unary path: keyed failover + hedging --------------------------------
    def _unary(self, mid: int, body: bytes, ctx: RpcContext, *,
               affinity: Optional[bytes] = None,
               hedge: bool = False) -> bytes:
        self._bump("requests")
        # one router-generated key covers every attempt of this logical
        # call: in-place retries dedup at the replica, and a failover
        # target executing it fresh is exactly the point (the original
        # execution died with its replica)
        key = str(_uuid.uuid4())
        tried: List[Replica] = []
        last: Optional[BaseException] = None
        attempts = max(1, min(self.cfg.max_attempts, len(self.replicas)))
        for i in range(attempts):
            ctx.check_deadline()
            r = self._pick(affinity=affinity, exclude=tried)
            if r is None:
                break
            tried.append(r)
            if i:
                self._bump("failovers")
            try:
                if hedge and len(self.replicas) > 1:
                    return self._call_hedged(r, mid, body, ctx, key,
                                             affinity=affinity)
                return self._call_one(r, mid, body, ctx, key)
            except _Failover as f:
                last = f.cause
                continue
        if last is not None:
            raise RpcError(Status.UNAVAILABLE,
                           f"all replicas failed: {last}")
        self._bump("no_replica_errors")
        raise RpcError(Status.UNAVAILABLE, "no healthy replica available")

    def _call_one(self, r: Replica, mid: int, body: bytes,
                  ctx: RpcContext, key: str) -> bytes:
        t0 = self._clock()
        with r.track():
            try:
                out = r.channel.call(mid, body, deadline=ctx.deadline,
                                     metadata={IDEMPOTENCY_KEY: key},
                                     timeout=self.cfg.attempt_timeout_s)
            # RETRYABLE before RpcError: TransportError/ClientTimeout ARE
            # RpcErrors (UNAVAILABLE/DEADLINE_EXCEEDED), and a wire
            # failure must hit the breaker, not the draining mark
            except self.RETRYABLE as e:
                r.breaker.record_failure()
                raise _Failover(e) from e
            except RpcError as e:
                if e.code == Status.UNAVAILABLE:
                    # the replica said no (draining): not an application
                    # error, resubmit elsewhere (the poll re-gates it)
                    r.draining = True
                    raise _Failover(e) from e
                r.breaker.record_success()  # it answered; the no is real
                raise
        r.observe(self._clock() - t0)
        r.breaker.record_success()
        return out

    def _hedge_delay(self) -> float:
        lats: List[float] = []
        for r in self.replicas:
            lats.extend(r.latencies)
        if len(lats) >= 16:
            lats.sort()
            q = lats[min(len(lats) - 1,
                         int(self.cfg.hedge_quantile * len(lats)))]
            return max(q, 1e-3)
        return self.cfg.hedge_delay_ms / 1e3

    def _call_hedged(self, r1: Replica, mid: int, body: bytes,
                     ctx: RpcContext, key: str, *,
                     affinity: Optional[bytes] = None) -> bytes:
        """Primary keyed call + a delayed unkeyed hedge; first wins.

        The hedge is deliberately unkeyed: when the primary wins, closing
        the hedge's channel fires the replica's cancel-on-disconnect hook
        (keyed calls run to completion for dedup-replay, unkeyed ones are
        cancellable) so the loser's KV blocks come back immediately.
        """
        q: _queue.Queue = _queue.Queue()
        done = threading.Event()
        hedge_ch: Dict[str, Channel] = {}

        def primary() -> None:
            try:
                q.put(("ok", self._call_one(r1, mid, body, ctx, key),
                       "primary"))
            except BaseException as e:  # noqa: BLE001 - relayed to caller
                q.put(("err", e, "primary"))

        def hedge() -> None:
            if done.wait(self._hedge_delay()):
                q.put(("skip", None, "hedge"))
                return
            r2 = self._pick(affinity=affinity, exclude=[r1])
            if r2 is None:
                q.put(("skip", None, "hedge"))
                return
            self._bump("hedges_fired")
            try:
                ch = Channel(r2.dial())
            except Exception:  # noqa: BLE001 - hedge is best-effort
                q.put(("skip", None, "hedge"))
                return
            hedge_ch["ch"] = ch
            t0 = self._clock()
            try:
                with r2.track():
                    out = ch.call(mid, body, deadline=ctx.deadline,
                                  timeout=self.cfg.attempt_timeout_s)
                r2.observe(self._clock() - t0)
                q.put(("ok", out, "hedge"))
            except BaseException:  # noqa: BLE001 - primary is authoritative
                q.put(("skip", None, "hedge"))

        threading.Thread(target=primary, daemon=True,
                         name="router-primary").start()
        threading.Thread(target=hedge, daemon=True,
                         name="router-hedge").start()
        value, who = None, None
        errs: List[BaseException] = []
        for _ in range(2):
            kind, payload, src = q.get()
            if kind == "ok":
                value, who = payload, src
                break
            if kind == "err":
                errs.append(payload)
        done.set()
        ch = hedge_ch.get("ch")
        if who == "primary" and ch is not None:
            ch.close()  # cancel the losing hedge server-side
            self._bump("hedges_cancelled")
        elif who == "hedge":
            self._bump("hedges_won")
            if ch is not None:
                ch.close()
        if value is not None:
            return value
        raise errs[0] if errs else _Failover(
            TransportError("hedged call produced no response"))

    # -- stream path: watermark failover + epoch guard -----------------------
    def _stream(self, mid: int, body: bytes, ctx: RpcContext,
                chunk_type, *, affinity: Optional[bytes] = None
                ) -> Iterator[bytes]:
        self._bump("requests")
        watermark = int(ctx.cursor or 0)
        failures = 0
        avoid: Optional[Replica] = None
        last: Optional[BaseException] = None
        while True:
            r = self._pick(affinity=affinity,
                           exclude=[avoid] if avoid is not None else [])
            if r is None and avoid is not None:
                r = self._pick(affinity=affinity)  # only the culprit left
            if r is None:
                self._bump("no_replica_errors")
                raise RpcError(Status.UNAVAILABLE,
                               f"no healthy replica available "
                               f"(watermark {watermark}, last: {last})")
            # each attempt rides its own channel: closing it on abandon
            # fires the replica's conn-close hook, killing the server-side
            # decode loop without touching the shared unary channel
            rc = ResilientChannel(r.dial, policy=self.cfg.policy,
                                  sleep=self._sleep, rng=self._rng)
            attempt_epoch: Optional[int] = None
            progressed = False
            try:
                with r.track():
                    items = rc.call(mid, body, server_stream=True,
                                    cursor=watermark, deadline=ctx.deadline,
                                    timeout=self.cfg.attempt_timeout_s)
                    for item in items:
                        chunk = wire.decode(chunk_type, item.payload)
                        ep = chunk.get("epoch")
                        if ep is not None:
                            if attempt_epoch is None:
                                attempt_epoch = ep
                                if r.epoch is None:
                                    r.epoch = ep
                            elif ep != attempt_epoch:
                                # the channel silently resumed into a
                                # RESTARTED process: its cursor promise is
                                # void — reject and re-issue explicitly
                                self._bump("epoch_rejections")
                                raise _EpochChanged()
                        if item.cursor is not None:
                            if item.cursor <= watermark:
                                continue  # replayed prefix: already sent
                            watermark = item.cursor
                            ctx.set_cursor(watermark)
                        progressed = True
                        yield item.payload
                r.breaker.record_success()
                return
            except _EpochChanged:
                failures += 1
                avoid = None  # same replica is fine: it answered, restarted
            except self.RETRYABLE as e:
                last = e
                r.breaker.record_failure()
                failures += 1
                avoid = r
                self._bump("stream_failovers")
            except RpcError as e:
                if e.code != Status.UNAVAILABLE:
                    raise          # the replica answered; the error is real
                r.draining = True  # server-sent draining refusal: move on
                last = e
                failures += 1
                avoid = r
                self._bump("stream_failovers")
            finally:
                rc.close()
            if failures >= self.cfg.stream_attempts:
                raise TransportError(
                    f"stream failed after {failures} attempts "
                    f"(watermark {watermark}): {last}")
            if not progressed:
                self._sleep(self.cfg.policy.delay(failures, self._rng))

    # -- service surface -----------------------------------------------------
    def handler(self, m) -> Callable:
        """Raw bytes->bytes forwarding handler for one service method."""
        mid = m.id
        if m.name == "Infer":
            def h(body: bytes, ctx: RpcContext) -> bytes:
                return self._unary(mid, body, ctx,
                                   affinity=self._affinity_key(body),
                                   hedge=self.cfg.hedge)
        elif m.name == "InferStream":
            def h(body: bytes, ctx: RpcContext) -> Iterator[bytes]:
                return self._stream(mid, body, ctx, m.response,
                                    affinity=self._affinity_key(body))
        elif m.kind == "server_stream":
            def h(body: bytes, ctx: RpcContext) -> Iterator[bytes]:
                return self._stream(mid, body, ctx, m.response)
        else:
            def h(body: bytes, ctx: RpcContext) -> bytes:
                return self._unary(mid, body, ctx)
        h.__name__ = m.name
        return h

    def collect_stats(self) -> Dict[str, float]:
        """Router counters plus per-replica channel/breaker/health state."""
        with self._stats_lock:
            out: Dict[str, float] = dict(self.stats)
        out["replicas"] = len(self.replicas)
        out["breaker_opens"] = sum(r.breaker.opens for r in self.replicas)
        for i, r in enumerate(self.replicas):
            cs = r.channel.collect_stats()
            out[f"replica{i}_reconnects"] = cs["reconnects"]
            out[f"replica{i}_retries"] = cs["retries"]
            out[f"replica{i}_gaps"] = cs["gaps"]
            out[f"replica{i}_routable"] = float(r.routable())
            out[f"replica{i}_draining"] = float(r.draining)
            out[f"replica{i}_inflight"] = float(r.inflight)
            out[f"replica{i}_queue_depth"] = float(r.queue_depth)
            out[f"replica{i}_breaker_open"] = \
                float(r.breaker.state != CircuitBreaker.CLOSED)
            out[f"replica{i}_breaker_opens"] = float(r.breaker.opens)
        return out

    def Stats(self, req: dict, ctx: RpcContext) -> dict:
        stats = self.collect_stats()
        names = sorted(stats)
        return {"names": "\n".join(names),
                "values": np.asarray([float(stats[n]) for n in names],
                                     np.float64)}

    def Health(self, req: dict, ctx: RpcContext) -> dict:
        draining = bool(self._server is not None and self._server.draining)
        routable = any(r.routable() for r in self.replicas)
        out: dict = {"serving": routable and not draining,
                     "draining": draining,
                     "inflight": sum(r.inflight for r in self.replicas),
                     "epoch": self.epoch}
        if req.get("verbose"):
            gauges = self.collect_stats()
            names = sorted(gauges)
            out["names"] = "\n".join(names)
            out["values"] = np.asarray([float(gauges[n]) for n in names],
                                       np.float64)
        return out

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n


def build_router_server(replicas: Sequence,
                        config: Optional[RouterConfig] = None, *,
                        descriptor: bytes = b"", start: bool = True,
                        **router_kw) -> Tuple[Server, ReplicaRouter]:
    """A Server speaking InferenceService, routing across ``replicas``.

    The proxy methods register untyped (bytes in, bytes out) so request
    payloads cross the router without a decode/encode round trip;
    Stats/Health register typed and answer locally.  The Server's own
    DedupCache makes client-keyed retries exactly-once end to end.
    """
    impl = ReplicaRouter(replicas, config, **router_kw)
    rt = Router()
    for m in InferenceService.methods:
        if m.name in ("Stats", "Health"):
            rt.register_handler(m.id, getattr(impl, m.name), name=m.name,
                                kind=m.kind, request_type=m.request,
                                response_type=m.response,
                                service=InferenceService.name)
        else:
            rt.register_handler(m.id, impl.handler(m), name=m.name,
                                kind=m.kind, service=InferenceService.name)
    server = Server(rt, descriptor=descriptor)
    impl.attach_server(server)
    if start:
        impl.start()
    return server, impl


class InProcessReplica:
    """A killable, restartable engine replica living in this process.

    Tests and ``chip_smoke.py`` use this as a stand-in for an engine
    subprocess: every replica owns its InferenceImpl (its own batcher and
    KV pool) over a shared Engine (shared weights and loaded kernels, so N
    replicas hold one copy of the weights).  On the card the replicas'
    batcher threads then launch on one device: each batcher keeps its own
    lock and pool, the model holds no state between calls, and the kernel
    launch counters take a lock (``kernels/build.py: count_launch``).
    ``kill()`` severs every handed-out transport and closes the batcher —
    in-flight work dies with the process, exactly like a crash — and
    ``restart()`` brings it back as a fresh impl with a fresh epoch.
    ``latency`` simulates a slow link (the one-slow-replica case of
    hedging).
    """

    _ids = itertools.count()

    def __init__(self, engine, name: Optional[str] = None, *,
                 latency: float = 0.0):
        self.engine = engine
        self.name = name or f"replica{next(self._ids)}"
        self.latency = latency
        self._lock = threading.Lock()
        self._open: List[Tuple[Transport, Transport]] = []  # guarded by _lock
        self._dead = True                                   # guarded by _lock
        self.impl: Optional[InferenceImpl] = None           # guarded by _lock
        self.server: Optional[Server] = None                # guarded by _lock
        self.start()

    @property
    def alive(self) -> bool:
        return not self._dead

    @property
    def epoch(self) -> Optional[int]:
        return self.impl.epoch if self.impl is not None else None

    def start(self) -> None:
        impl = InferenceImpl(self.engine)
        server = build_server(self.engine, impl=impl)
        # publish atomically: a dial() racing a restart() must never see
        # _dead flipped while impl/server still point at the old process
        with self._lock:
            self.impl = impl
            self.server = server
            self._dead = False

    def dial(self) -> Transport:
        with self._lock:
            if self._dead:
                raise ConnectionError(f"{self.name} is down")
            client, served = connected_pair(self.latency)
            self._open.append((client, served))
        self.server.serve_transport(served, blocking=False)
        return client

    def kill(self) -> None:
        """Crash: sever every connection, abort the batcher's work."""
        with self._lock:
            if self._dead:
                return
            self._dead = True
            conns, self._open = self._open, []
        for client, served in conns:
            for t in (client, served):
                try:
                    t.close()
                except Exception:  # noqa: BLE001 - already tearing down
                    pass
        batcher = self.impl.batcher if self.impl is not None else None
        close = getattr(batcher, "close", None)
        if close is not None:
            # close() joins the batcher worker; do it off-thread so a
            # kill mid-decode is as instant as a real SIGKILL
            threading.Thread(target=close, daemon=True,
                             name=f"{self.name}-reap").start()

    def restart(self) -> None:
        """Crash + come back as a fresh process (new epoch, empty caches)."""
        self.kill()
        self.start()
