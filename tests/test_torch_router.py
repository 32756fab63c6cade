"""The port's replica router against the JAX package's.

* **Routing, no model.**  The JAX ``tests/test_router.py`` cases against
  the port's router, over stub replicas that speak the port's
  ``InferenceService`` on in-memory transports: circuit-breaker
  transitions, consistent-hash prefix affinity, health gating, load
  scoring, the poll's epoch count, keyed unary failover, the breaker
  opening, hedged requests (win and cancel), stream failover from the
  delivered-cursor watermark, the epoch guard against a silently
  restarted process, client-keyed dedup at the router, and the
  Stats/Health surface.  The port's ring, affinity keys and counter names
  equal the JAX router's.
* **Across packages.**  On one set of weights (drawn by the JAX init,
  ``params_from_numpy``, ``reduced_config`` in float32), the port's router
  in front of two JAX ``InProcessReplica``s and the JAX router in front
  of two of the port's give ``Infer`` pages and ``InferStream`` chunks
  byte-identical to one replica of either package.
* **One engine, two replicas.**  Two of the port's replicas share one
  engine and run their batchers at once: a concurrent wave returns one
  replica's pages and gives every block back; the kernel launch counters
  they share lose no update under sixteen threads.

``tests/test_torch_chaos.py`` runs the port's router over the port's
replicas under injected wire faults.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core.rpc import Channel as JaxChannel
from repro.core.rpc import connected_pair as jax_connected_pair
from repro.serving import Engine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import build_server as jax_build_server
from repro.serving import router as jrouter
from repro.serving import service as jservice

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import wire
from repro_torch.core.rpc import (Channel, IDEMPOTENCY_KEY, Router, RpcError,
                                  Server, Status, connected_pair)
from repro_torch.serving import (Engine, InferenceImpl, InProcessReplica,
                                 ServeConfig, build_server)
from repro_torch.serving.router import (CircuitBreaker, ReplicaRouter,
                                        RouterConfig, build_router_server)
from repro_torch.serving.service import (InferChunk, InferenceService,
                                         InferRequest, encode_prompt_page)

INFER = InferenceService.method("Infer").id
STREAM = InferenceService.method("InferStream").id


class StubReplica:
    """InferenceService speaker with scriptable delays, kill and restart.

    ``restart()`` bumps the epoch — the stand-in for a process coming
    back with a fresh ``time_ns`` stamp — while keeping the same dial,
    which is exactly the silent-resume hazard the epoch guard exists for.
    """

    def __init__(self, name, *, chunks=4, infer_delay=0.0, chunk_delay=0.0,
                 queue_depth=0.0):
        self.name = name
        self.chunks = chunks
        self.infer_delay = infer_delay
        self.chunk_delay = chunk_delay
        self.queue_depth = queue_depth
        self.epoch = 1
        self.draining = False
        self.infer_calls = 0
        self.stream_calls = 0
        self._dead = False
        self._open = []
        self._lock = threading.Lock()
        rt = Router()
        for mname in ("Infer", "InferStream", "Health"):
            m = InferenceService.method(mname)
            rt.register_handler(m.id, getattr(self, mname), name=m.name,
                                kind=m.kind, request_type=m.request,
                                response_type=m.response,
                                service=InferenceService.name)
        self.server = Server(rt)

    # -- handlers -------------------------------------------------------------
    def Infer(self, req, ctx):
        self.infer_calls += 1
        if self.infer_delay:
            time.sleep(self.infer_delay)
        # echo the request page with this replica's name appended, so
        # tests can see exactly which replica answered
        page = bytes(bytearray(req["page"])) + self.name.encode()
        return {"page": page, "batch": 1, "new_tokens": 0}

    def InferStream(self, req, ctx):
        self.stream_calls += 1
        start = int(ctx.cursor or 0)
        for i in range(start, self.chunks):
            if self.chunk_delay:
                time.sleep(self.chunk_delay)
            ctx.set_cursor(i + 1)
            yield {"index": i, "page": b"chunk-%d" % i, "epoch": self.epoch}

    def Health(self, req, ctx):
        out = {"serving": not self.draining, "draining": self.draining,
               "inflight": 0, "epoch": self.epoch}
        if req.get("verbose"):
            out["names"] = "queued_requests"
            out["values"] = np.asarray([self.queue_depth], np.float64)
        return out

    # -- process lifecycle ----------------------------------------------------
    def dial(self):
        with self._lock:
            if self._dead:
                raise ConnectionError(f"{self.name} is down")
            client, served = connected_pair()
            self._open.append((client, served))
        self.server.serve_transport(served, blocking=False)
        return client

    def kill(self):
        with self._lock:
            self._dead = True
            conns, self._open = self._open, []
        for pair in conns:
            for t in pair:
                try:
                    t.close()
                except Exception:  # noqa: BLE001
                    pass

    def restart(self):
        """Crash and come straight back with a new process epoch."""
        self.kill()
        self.epoch += 1
        with self._lock:
            self._dead = False


def _dial_server(server):
    ct, st = connected_pair()
    server.serve_transport(st, blocking=False)
    return ct


def _build(stubs, **cfg_kw):
    cfg_kw.setdefault("health_interval_s", 0)   # tests poll manually
    cfg_kw.setdefault("hedge", False)
    server, router = build_router_server(stubs, RouterConfig(**cfg_kw))
    return server, router


PROMPT = np.arange(32, dtype=np.uint32)[None, :]
REQ_RAW = wire.encode(InferRequest, {"page": encode_prompt_page(PROMPT),
                                     "max_new_tokens": 4})


def _infer_req():
    return {"page": encode_prompt_page(PROMPT), "max_new_tokens": 4}


# -- the same decisions as the JAX router -------------------------------------

def test_config_ring_affinity_and_counters_match_jax():
    import dataclasses
    cfg, jcfg = RouterConfig(), jrouter.RouterConfig()
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "policy"} == \
        {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
         if f.name != "policy"}
    pol, jpol = dataclasses.asdict(cfg.policy), dataclasses.asdict(jcfg.policy)
    assert [c.__name__ for c in pol.pop("retry_on")] == \
        [c.__name__ for c in jpol.pop("retry_on")]
    assert pol == jpol
    names = [f"s{i}" for i in range(3)]
    kw = dict(health_interval_s=0, affinity_prefix=16, affinity_block=16)
    router = ReplicaRouter([StubReplica(n) for n in names], RouterConfig(**kw))
    jr = jrouter.ReplicaRouter(
        [jrouter.Replica(n, lambda: None, jrouter.RouterConfig(**kw))
         for n in names], jrouter.RouterConfig(**kw))
    assert router._ring == jr._ring
    key = router._affinity_key(REQ_RAW)
    assert key == jr._affinity_key(REQ_RAW) is not None
    assert [r.name for r in router._ring_order(key)] == \
        [r.name for r in jr._ring_order(key)]
    assert router.stats.keys() == jr.stats.keys()


# -- circuit breaker ----------------------------------------------------------

def test_breaker_opens_probes_and_recloses():
    clk = {"t": 0.0}
    b = CircuitBreaker(threshold=2, reset_after=5.0,
                       clock=lambda: clk["t"])
    assert b.ready() and b.allow()
    b.record_failure()
    assert b.state == b.CLOSED      # one failure is below threshold
    b.record_failure()
    assert b.state == b.OPEN and b.opens == 1
    assert not b.ready() and not b.allow()
    clk["t"] = 5.0                  # reset window elapsed
    assert b.ready()
    assert b.allow()                # this caller is the half-open probe
    assert b.state == b.HALF_OPEN
    assert not b.allow()            # only ONE probe is admitted
    b.record_failure()              # probe failed: straight back to open
    assert b.state == b.OPEN and b.opens == 2
    clk["t"] = 10.0
    assert b.allow()
    b.record_success()              # probe succeeded: fully closed
    assert b.state == b.CLOSED and b.failures == 0 and b.allow()


# -- affinity -----------------------------------------------------------------

def test_affinity_key_is_block_aligned_prefix():
    _, router = _build([StubReplica("a"), StubReplica("b")],
                       affinity_prefix=16, affinity_block=16)
    key = router._affinity_key(REQ_RAW)
    assert key == PROMPT[0, :16].astype("<u4").tobytes()
    # prompts sharing the first block map to the same key even when the
    # tail diverges
    other = PROMPT.copy()
    other[0, 20:] += 7
    raw2 = wire.encode(InferRequest, {"page": encode_prompt_page(other),
                                      "max_new_tokens": 4})
    assert router._affinity_key(raw2) == key
    # shorter than one block -> no affinity; malformed -> no affinity
    short = wire.encode(InferRequest, {
        "page": encode_prompt_page(PROMPT[:, :8]), "max_new_tokens": 4})
    assert router._affinity_key(short) is None
    assert router._affinity_key(b"\x00garbage") is None


def test_affinity_routing_is_sticky_with_consistent_failover():
    stubs = [StubReplica(f"s{i}") for i in range(3)]
    _, router = _build(stubs, affinity_prefix=16, affinity_block=16)
    key = router._affinity_key(REQ_RAW)
    first = router._pick(affinity=key)
    assert all(router._pick(affinity=key) is first for _ in range(10))
    # gate the owner out: the fallback is a deterministic second choice
    first.poll_ok = False
    second = router._pick(affinity=key)
    assert second is not None and second is not first
    assert all(router._pick(affinity=key) is second for _ in range(10))
    first.poll_ok = True           # owner back: affinity snaps back
    assert router._pick(affinity=key) is first
    # different keys actually spread across replicas
    owners = set()
    for seed in range(32):
        k = np.full(16, seed, np.uint32).tobytes()
        owners.add(router._pick(affinity=k).name)
    assert len(owners) > 1


# -- health gating and load ---------------------------------------------------

def test_poll_gates_out_draining_and_dead_replicas():
    stubs = [StubReplica("a"), StubReplica("b"), StubReplica("c")]
    _, router = _build(stubs)
    router.poll()
    assert all(r.routable() for r in router.replicas)
    assert router.stats["health_polls"] == 3
    stubs[1].draining = True
    stubs[2].kill()
    router.poll()
    assert router.replicas[0].routable()
    assert not router.replicas[1].routable()   # draining via Health
    assert not router.replicas[2].routable()   # dial refused
    assert router.stats["health_poll_failures"] == 1
    assert router._pick() is router.replicas[0]
    stubs[2]._dead = False                     # back up: next poll re-gates
    stubs[1].draining = False
    router.poll()
    assert all(r.routable() for r in router.replicas)


def test_pick_prefers_lowest_load():
    stubs = [StubReplica("a", queue_depth=5.0), StubReplica("b"),
             StubReplica("c", queue_depth=2.0)]
    _, router = _build(stubs)
    router.poll()                  # pulls queued_requests into the score
    assert router._pick() is router.replicas[1]
    router.replicas[1].inflight = 4   # 2x weight: now the worst choice
    assert router._pick() is router.replicas[2]


def test_poll_epoch_change_is_counted():
    stubs = [StubReplica("a")]
    _, router = _build(stubs)
    router.poll()
    assert router.replicas[0].epoch == 1
    stubs[0].restart()
    router.poll()
    assert router.replicas[0].epoch == 2
    assert router.stats["epoch_changes"] == 1


# -- unary failover -----------------------------------------------------------

def test_unary_failover_to_survivor():
    stubs = [StubReplica("a"), StubReplica("b")]
    server, router = _build(stubs)
    ch = Channel(_dial_server(server))
    inf = ch.typed(InferenceService)
    stubs[0].kill()
    stubs[1].kill()
    with pytest.raises(RpcError) as ei:   # nobody left -> UNAVAILABLE
        inf.Infer(_infer_req(), timeout=10.0)
    assert ei.value.code == Status.UNAVAILABLE
    stubs[1]._dead = False                # one survivor
    res = inf.Infer(_infer_req(), timeout=10.0)
    assert bytes(bytearray(res["page"])).endswith(b"b")
    assert router.stats["failovers"] >= 1
    assert stubs[0].infer_calls == 0 and stubs[1].infer_calls == 1
    ch.close()


def test_unary_failures_open_breaker():
    stubs = [StubReplica("a")]
    server, router = _build(stubs, breaker_threshold=2, breaker_reset_s=60.0)
    ch = Channel(_dial_server(server))
    inf = ch.typed(InferenceService)
    stubs[0].kill()
    for _ in range(2):
        with pytest.raises(RpcError):
            inf.Infer(_infer_req(), timeout=10.0)
    r = router.replicas[0]
    assert r.breaker.state == CircuitBreaker.OPEN
    assert not r.routable()
    assert router.collect_stats()["breaker_opens"] >= 1
    # with the breaker open the router refuses instantly (no dial storm)
    with pytest.raises(RpcError) as ei:
        inf.Infer(_infer_req(), timeout=10.0)
    assert ei.value.code == Status.UNAVAILABLE
    assert router.stats["no_replica_errors"] >= 1
    ch.close()


# -- hedging ------------------------------------------------------------------

def test_hedge_wins_when_primary_is_slow():
    stubs = [StubReplica("slow", infer_delay=0.6), StubReplica("fast")]
    server, router = _build(stubs, hedge=True, hedge_delay_ms=30.0,
                            affinity_prefix=0)  # load routing: slow first
    ch = Channel(_dial_server(server))
    inf = ch.typed(InferenceService)
    t0 = time.monotonic()
    res = inf.Infer(_infer_req(), timeout=10.0)
    assert bytes(bytearray(res["page"])).endswith(b"fast")
    assert time.monotonic() - t0 < 0.6      # did not wait out the primary
    assert router.stats["hedges_fired"] == 1
    assert router.stats["hedges_won"] == 1
    ch.close()


def test_hedge_cancelled_when_primary_wins():
    stubs = [StubReplica("fast", infer_delay=0.15),
             StubReplica("spare", infer_delay=10.0)]
    server, router = _build(stubs, hedge=True, hedge_delay_ms=1.0,
                            affinity_prefix=0)
    ch = Channel(_dial_server(server))
    inf = ch.typed(InferenceService)
    res = inf.Infer(_infer_req(), timeout=10.0)
    assert bytes(bytearray(res["page"])).endswith(b"fast")
    assert router.stats["hedges_fired"] == 1
    assert router.stats["hedges_cancelled"] == 1
    assert router.stats["hedges_won"] == 0
    ch.close()


# -- streams: watermark failover + epoch guard --------------------------------

def _collect_stream(ch, on_item=None, timeout=15.0):
    pages = []
    for item in ch.call(STREAM, REQ_RAW, server_stream=True,
                        timeout=timeout):
        chunk = wire.decode(InferChunk, item.payload)
        pages.append(bytes(bytearray(chunk["page"])))
        if on_item is not None:
            on_item(len(pages))
    return pages


def test_stream_failover_is_gap_and_duplicate_free():
    stubs = [StubReplica(f"s{i}", chunks=6, chunk_delay=0.03)
             for i in range(2)]
    server, router = _build(stubs)
    baseline = [b"chunk-%d" % i for i in range(6)]
    ch = Channel(_dial_server(server))

    def kill_owner_at_two(n):
        if n == 2:
            for stub, rep in zip(stubs, router.replicas):
                if rep.inflight:
                    stub.kill()

    got = _collect_stream(ch, on_item=kill_owner_at_two)
    assert got == baseline
    assert router.stats["stream_failovers"] >= 1
    # the survivor resumed from the watermark, not from scratch: its
    # chunks start past what the dead replica already delivered
    assert stubs[0].stream_calls + stubs[1].stream_calls >= 2
    ch.close()


def test_stream_epoch_guard_rejects_silent_resume():
    stubs = [StubReplica("only", chunks=6, chunk_delay=0.03)]
    server, router = _build(stubs)
    baseline = [b"chunk-%d" % i for i in range(6)]
    ch = Channel(_dial_server(server))

    def restart_at_two(n):
        if n == 2:
            stubs[0].restart()    # same dial, NEW epoch: the trap

    got = _collect_stream(ch, on_item=restart_at_two)
    assert got == baseline
    # the per-attempt channel silently resumed into the restarted
    # process; the guard must have rejected that delivery
    assert router.stats["epoch_rejections"] >= 1
    ch.close()


def test_client_keyed_retry_dedups_at_router():
    stubs = [StubReplica("a")]
    server, router = _build(stubs)
    ch = Channel(_dial_server(server))
    md = {IDEMPOTENCY_KEY: "logical-call-1"}
    r1 = ch.call(INFER, REQ_RAW, metadata=dict(md), timeout=10.0)
    r2 = ch.call(INFER, REQ_RAW, metadata=dict(md), timeout=10.0)
    assert bytes(r1) == bytes(r2)
    assert stubs[0].infer_calls == 1      # replayed, not re-executed
    assert server.dedup.hits == 1
    ch.close()


# -- stats surface ------------------------------------------------------------

def test_router_stats_and_health_rpcs():
    stubs = [StubReplica("a"), StubReplica("b")]
    server, router = _build(stubs)
    router.poll()
    ch = Channel(_dial_server(server))
    inf = ch.typed(InferenceService)
    inf.Infer(_infer_req(), timeout=10.0)
    st = inf.Stats({})
    stats = dict(zip(st["names"].split("\n"),
                     np.asarray(st["values"], np.float64)))
    for k in ("requests", "failovers", "stream_failovers", "hedges_fired",
              "epoch_rejections", "breaker_opens", "replicas",
              "replica0_reconnects", "replica0_retries", "replica0_gaps",
              "replica1_routable", "replica1_breaker_open"):
        assert k in stats, f"missing stat {k}"
    assert stats["requests"] == 1 and stats["replicas"] == 2
    h = inf.Health({"verbose": True})
    assert h["serving"] and not h["draining"]
    assert h["epoch"] == router.epoch
    assert "requests" in h["names"].split("\n")
    # every replica gone -> the router reports itself unserving
    for s in stubs:
        s.kill()
    router.poll()
    h2 = inf.Health({})
    assert not h2["serving"]
    ch.close()


# -- across packages ----------------------------------------------------------

SC = dict(cache_len=64, max_new_tokens=8)
CROSS_PROMPTS = [np.random.default_rng(s).integers(0, 512, (1, t)).astype(
    np.uint32) for s, t in ((21, 9), (22, 24), (23, 5))]


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and the port's on the JAX init's weights."""
    jcfg = jax_reduced_config(jax_get_config("qwen2-1.5b"))
    cfg = reduced_config(get_config("qwen2-1.5b"))
    jengine = JaxEngine(jcfg, JaxServeConfig(**SC))
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jengine.params), device="cpu",
        dtype=torch.float32)
    engine = Engine(cfg, ServeConfig(**SC), params=params, device="cpu")
    return jengine, engine


def _pages_and_stream(inf):
    """Every cross prompt's ``Infer`` page, then the first one's
    ``InferStream`` chunk pages."""
    pages = [bytes(bytearray(inf.Infer({"page": encode_prompt_page(p),
                                        "max_new_tokens": 6},
                                       timeout=60.0)["page"]))
             for p in CROSS_PROMPTS]
    chunks = [bytes(bytearray(c["page"])) for c in inf.InferStream(
        {"page": encode_prompt_page(CROSS_PROMPTS[0]), "max_new_tokens": 6},
        timeout=60.0)]
    return pages, chunks


@pytest.fixture(scope="module")
def baseline(engines):
    """One replica of each package, without a router: both must agree."""
    jengine, engine = engines
    impl = InferenceImpl(engine)
    out = []
    for server, chan, pair, svc in (
            (jax_build_server(jengine), JaxChannel, jax_connected_pair,
             jservice.InferenceService),
            (build_server(engine, impl=impl), Channel, connected_pair,
             InferenceService)):
        ct, st = pair()
        server.serve_transport(st, blocking=False)
        ch = chan(ct)
        try:
            out.append(_pages_and_stream(ch.typed(svc)))
        finally:
            ch.close()
            server.drain(timeout=10)
    impl.close()
    assert out[0] == out[1]
    assert all(len(p) for p in out[0][0]) and len(out[0][1]) == 6
    return out[0]


def _through_router(build, replicas, chan, pair, svc, **cfg_kw):
    server, router = build(replicas, **cfg_kw)
    ct, st = pair()
    server.serve_transport(st, blocking=False)
    ch = chan(ct)
    try:
        return _pages_and_stream(ch.typed(svc)), router
    finally:
        ch.close()
        router.close()
        for r in replicas:
            r.kill()


def test_port_router_over_jax_replicas_matches_one_replica(engines,
                                                           baseline):
    jengine, _ = engines
    replicas = [jrouter.InProcessReplica(jengine, f"jrep{i}")
                for i in range(2)]
    got, router = _through_router(
        build_router_server, replicas, Channel, connected_pair,
        InferenceService, config=RouterConfig(health_interval_s=0,
                                              hedge=False))
    assert got == baseline
    assert router.stats["requests"] == len(CROSS_PROMPTS) + 1


def test_jax_router_over_port_replicas_matches_one_replica(engines,
                                                           baseline):
    _, engine = engines
    replicas = [InProcessReplica(engine, f"rep{i}") for i in range(2)]
    got, router = _through_router(
        jrouter.build_router_server, replicas, JaxChannel,
        jax_connected_pair, jservice.InferenceService,
        config=jrouter.RouterConfig(health_interval_s=0, hedge=False))
    assert got == baseline
    assert router.stats["requests"] == len(CROSS_PROMPTS) + 1


def test_two_replicas_on_one_engine_serve_concurrently(engines, baseline):
    """Two ``InProcessReplica``s share one engine (weights, model, kernel
    counters) and run their batchers at once: a wave sent together,
    routed by load so both replicas take part, returns one replica's
    pages, and each replica hands its blocks back."""
    from concurrent.futures import ThreadPoolExecutor
    _, engine = engines
    replicas = [InProcessReplica(engine, f"rep{i}") for i in range(2)]
    server, router = build_router_server(
        replicas, RouterConfig(health_interval_s=0, hedge=False,
                               affinity_prefix=0))

    def infer(prompt):
        ch = Channel(_dial_server(server))
        try:
            return bytes(bytearray(ch.typed(InferenceService).Infer(
                {"page": encode_prompt_page(prompt), "max_new_tokens": 6},
                timeout=60.0)["page"]))
        finally:
            ch.close()
    try:
        with ThreadPoolExecutor(2 * len(CROSS_PROMPTS)) as ex:
            got = list(ex.map(infer, CROSS_PROMPTS + CROSS_PROMPTS))
        served = [r.impl.batcher.collect_stats()["requests"]
                  for r in replicas]
        assert got == baseline[0] + baseline[0]
        assert min(served) > 0 and sum(served) == len(got)
        for r in replicas:
            cache = r.impl.batcher.cache
            end = time.monotonic() + 10.0
            while cache.num_free_blocks + cache.reclaimable \
                    != cache.allocator.capacity and time.monotonic() < end:
                time.sleep(0.01)
            assert cache.num_free_blocks + cache.reclaimable \
                == cache.allocator.capacity, f"{r.name} leaked KV blocks"
    finally:
        router.close()
        for r in replicas:
            r.kill()


def test_launch_counter_holds_under_concurrent_callers():
    """Replicas' batchers on one card bump the same kernel launch counters
    from several threads; ``count_launch`` must lose no update."""
    import sys
    from repro_torch.kernels import build

    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, n_calls = 16, 2000

    def bump():
        for _ in range(n_calls):
            build.count_launch(wrapper)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * n_calls
