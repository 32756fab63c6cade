"""End-to-end chaos on the port: its serving stack under a seeded lossy wire.

The port's copies of ``tests/test_chaos.py``, over the port's replicas
(``reduced_config`` qwen2-1.5b in float32 on the CPU, weights drawn by the
JAX init and loaded by ``params_from_numpy``).  With drop, corrupt and
disconnect faults each injected at 5% per frame on both directions
(``FaultInjectingTransport``, the fixed seed only):

  * unary ``Infer`` through a ``ResilientChannel`` returns token pages
    bit-identical to the fault-free run, whose page is the JAX server's
    on the same weights, and the handler runs exactly once per logical
    call (idempotency-key dedup);
  * ``InferStream`` delivers the fault-free token sequence, gap-free and
    duplicate-free, across the cursor resumes the faults force;
  * no KV blocks leak (prefix cache off, so free == capacity exactly);
  * a client that disconnects mid-``Infer`` without an idempotency key
    has its blocks reclaimed (cancel-on-disconnect);
  * the router over two ``InProcessReplica``s keeps a stream and a keyed
    ``Infer`` whole across a replica kill, and over fault-injected
    replica links;
  * the replica supervisor restarts crashed replicas under capped
    backoff and rolls them one at a time (stub processes, no clock);
  * graceful drain finishes in-flight work before shutdown.

Wall-clock bounds.  The tier-1 run puts these tests under six xdist
workers on eight cores beside the JAX package's.  In two such runs on an
8-core CPU host, a warm ``Infer`` of this setup took at most 0.14 s,
three chaos ``Infer`` calls with their retries 0.33 s, and nine calls
were in flight 0.0085 s after they were sent; each bound below is at
least ten times the measured time it covers.  The drain case holds the
batcher's lock until all its calls are in flight, and the stream-kill
case holds the stream's second decode step until the kill, so neither
depends on how the threads are scheduled.
"""
import queue
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
from repro.serving import service as jservice

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import wire
from repro_torch.core.retry import RetryPolicy
from repro_torch.core.rpc import (IDEMPOTENCY_KEY, Channel,
                                  FaultInjectingTransport, FaultSpec,
                                  ResilientChannel, RpcError, connected_pair)
from repro_torch.launch.serve import ReplicaSupervisor
from repro_torch.serving import (Engine, InferenceImpl, InProcessReplica,
                                 ServeConfig, build_server)
from repro_torch.serving.router import RouterConfig, build_router_server
from repro_torch.serving.service import (InferChunk, InferenceService,
                                         InferRequest, encode_prompt_page)

FIXED_SEED = 20240808

#: the acceptance bar: every damaging fault class at >= 5% per frame
CHAOS = FaultSpec(drop=0.05, corrupt=0.05, disconnect=0.05)

#: per-attempt wait of a ResilientChannel call under faults (a dropped
#: frame costs one such wait before the retry): >= 10 x a warm Infer
ATTEMPT_TIMEOUT = 2.0
#: waits for calls to arrive, for blocks to come back and for a call to
#: end (module docstring)
ARRIVE_S, CONSERVE_S, CALL_S = 10.0, 15.0, 30.0
#: retries are generous because a 15%-per-frame fault rate can kill
#: several attempts in a row
POLICY = RetryPolicy(attempts=12, base_delay=0.02, max_delay=0.1,
                     jitter=0.25, retry_on=ResilientChannel.RETRYABLE)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced_config(jax_get_config("qwen2-1.5b"))
    cfg = reduced_config(get_config("qwen2-1.5b"))
    # prefix_cache off so block conservation is exact: free == capacity
    # once no request is resident (cached prefixes intentionally linger)
    sc = dict(cache_len=64, max_new_tokens=8, prefix_cache=False)
    jengine = JaxEngine(jcfg, JaxServeConfig(**sc))
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jengine.params), device="cpu",
        dtype=torch.float32)
    engine = Engine(cfg, ServeConfig(**sc), params=params, device="cpu")
    impl = InferenceImpl(engine)
    server = build_server(engine, impl=impl)
    prompt = (np.random.default_rng(1234)
              .integers(0, cfg.vocab_size, (1, 8)).astype(np.uint32))
    req = {"page": encode_prompt_page(prompt), "max_new_tokens": 6}
    # fault-free baseline
    ct, st = connected_pair()
    server.serve_transport(st, blocking=False)
    ch = Channel(ct)
    inf = ch.typed(InferenceService)
    baseline_page = bytes(bytearray(inf.Infer(dict(req))["page"]))
    sid = InferenceService.method("InferStream").id
    raw = wire.encode(InferRequest, req)
    baseline_stream = [
        bytes(bytearray(wire.decode(InferChunk, i.payload)["page"]))
        for i in ch.call(sid, raw, server_stream=True)]
    assert len(baseline_stream) == 6
    # ... which is the JAX server's page on the same weights
    jserver = jax_build_server(jengine)
    jct, jst = jax_connected_pair()
    jserver.serve_transport(jst, blocking=False)
    jch = JaxChannel(jct)
    assert bytes(bytearray(jch.typed(jservice.InferenceService).Infer(
        dict(req))["page"])) == baseline_page
    jch.close()
    yield {"cfg": cfg, "engine": engine, "impl": impl, "server": server,
           "req": req, "raw": raw, "sid": sid,
           "baseline_page": baseline_page,
           "baseline_stream": baseline_stream}
    ch.close()
    server.drain(timeout=10)
    impl.close()


def _chaos_factory(server, seed):
    """Each dial: fresh in-memory pair to ``server``, chaos wrappers on
    BOTH directions, seeds derived from (seed, dial index) so runs are
    reproducible."""
    dials = {"n": 0}

    def dial():
        ct, st = connected_pair()
        k = dials["n"]
        dials["n"] += 1
        server.serve_transport(
            FaultInjectingTransport(st, CHAOS, seed=seed * 1000 + 2 * k + 1),
            blocking=False)
        return FaultInjectingTransport(ct, CHAOS, seed=seed * 1000 + 2 * k)

    return dial


def _free_blocks(impl):
    return impl.batcher.cache.num_free_blocks


def _capacity(impl):
    return impl.batcher.cache.allocator.capacity


def _wait_conserved(impl, timeout=CONSERVE_S):
    """True once every KV block is back in the pool."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if _free_blocks(impl) == _capacity(impl):
            return True
        time.sleep(0.02)
    return False


def _wait(cond, timeout=ARRIVE_S):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.002)
    return cond()


def test_chaos_infer_bit_identical(setup):
    server, impl = setup["server"], setup["impl"]
    seed = FIXED_SEED
    rc = ResilientChannel(_chaos_factory(server, seed),
                          policy=POLICY)
    inf = rc.typed(InferenceService)
    before = impl.batcher.stats["requests"]
    for _ in range(3):
        res = inf.Infer(dict(setup["req"]), timeout=ATTEMPT_TIMEOUT)
        page = bytes(bytearray(res["page"]))
        assert page == setup["baseline_page"], \
            f"seed {seed}: tokens diverged from fault-free baseline"
    # exactly-once: dedup means retries never reach the batcher twice
    assert impl.batcher.stats["requests"] - before == 3, \
        f"seed {seed}: handler executed more than once per logical call"
    rc.close()
    assert _wait_conserved(impl), \
        f"seed {seed}: leaked KV blocks " \
        f"({_free_blocks(impl)}/{_capacity(impl)} free)"


def test_chaos_infer_stream_gap_and_duplicate_free(setup):
    seed = FIXED_SEED
    rc = ResilientChannel(_chaos_factory(setup["server"], seed + 7),
                          policy=POLICY)
    it = rc.call(setup["sid"], setup["raw"], server_stream=True,
                 timeout=ATTEMPT_TIMEOUT)
    pages, cursors = [], []
    for item in it:
        chunk = wire.decode(InferChunk, item.payload)
        pages.append(bytes(bytearray(chunk["page"])))
        cursors.append(item.cursor)
    assert pages == setup["baseline_stream"], \
        f"seed {seed}: stream diverged (gaps, dups, or wrong tokens)"
    assert cursors == sorted(set(cursors)), \
        f"seed {seed}: cursors not strictly increasing: {cursors}"
    rc.close()
    assert _wait_conserved(setup["impl"]), f"seed {seed}: leaked KV blocks"


def test_unkeyed_disconnect_reclaims_blocks(setup):
    """A plain Channel (no idempotency key) that dies mid-Infer must not
    keep paying for decode: cancel-on-disconnect frees its blocks.  The
    victim is submitted behind a full batch of fillers from a healthy
    connection, so it is still pending when its connection dies."""
    server, impl = setup["server"], setup["impl"]
    stats = impl.batcher.stats
    cancelled_before = stats["cancelled"]
    requests_before = stats["requests"]
    sid = InferenceService.method("Infer").id
    raw = wire.encode(InferRequest, dict(setup["req"], max_new_tokens=8))

    kct, kst = connected_pair()
    server.serve_transport(kst, blocking=False)
    keeper = Channel(kct)
    n_fill = impl.batcher.max_batch
    fills: "queue.Queue" = queue.Queue()
    for _ in range(n_fill):
        threading.Thread(
            target=lambda: fills.put(keeper.call(sid, raw, timeout=CALL_S)),
            daemon=True).start()
    _wait(lambda: stats["requests"] >= requests_before + n_fill)

    ct, st = connected_pair()
    server.serve_transport(st, blocking=False)
    ch = Channel(ct)
    results: "queue.Queue" = queue.Queue()

    def call():
        try:
            results.put(ch.call(sid, raw, timeout=CALL_S))
        except RpcError as e:
            results.put(e)

    threading.Thread(target=call, daemon=True).start()
    _wait(lambda: stats["requests"] >= requests_before + n_fill + 1)
    ct.close()         # the caller vanishes
    st.close()
    for _ in range(n_fill):
        fills.get(timeout=CALL_S)  # fillers unaffected by the dead peer
    assert _wait_conserved(impl), "disconnected caller's blocks leaked"
    out = results.get(timeout=CALL_S)
    assert isinstance(out, RpcError)  # the local call observed the loss
    assert stats["cancelled"] > cancelled_before, \
        "dead connection's pending request was never cancelled"
    keeper.close()


def _router_setup(setup, n=2, **cfg_kw):
    """N killable in-process replicas (own batchers, shared engine)
    behind a router server, plus a plain client channel to the router."""
    replicas = [InProcessReplica(setup["engine"], f"rep{i}")
                for i in range(n)]
    cfg_kw.setdefault("health_interval_s", 0)   # tests poll manually
    cfg_kw.setdefault("hedge", False)
    # the 8-token chaos prompt spans one affinity block at block=8, so
    # identical prompts pin to one deterministic victim replica
    cfg_kw.setdefault("affinity_block", 8)
    cfg_kw.setdefault("affinity_prefix", 8)
    dial = cfg_kw.pop("dial", None)
    targets = replicas if dial is None else [dial(r) for r in replicas]
    server, router = build_router_server(targets, RouterConfig(**cfg_kw))
    ct, st = connected_pair()
    server.serve_transport(st, blocking=False)
    return replicas, router, Channel(ct)


def test_router_stream_survives_replica_kill(setup):
    """Kill the replica carrying an InferStream mid-flight: the client's
    plain Channel sees the untouched baseline sequence — the router
    resumes on the survivor from its delivered-cursor watermark.  The
    stream's second decode step (the one that makes chunk 2) waits until
    the kill, so the stream is still in flight when the client has read
    two chunks, however slowly the client runs."""
    model = setup["engine"].model
    step = model.decode_step
    calls, release = [0], threading.Event()

    def held(*args):
        calls[0] += 1
        if calls[0] == 2:
            release.wait(CALL_S)
        return step(*args)

    model.decode_step = held
    replicas, router, ch = _router_setup(setup)
    try:
        pages, killed = [], []
        for item in ch.call(setup["sid"], setup["raw"], server_stream=True,
                            timeout=CALL_S):
            chunk = wire.decode(InferChunk, item.payload)
            pages.append(bytes(bytearray(chunk["page"])))
            if len(pages) == 2 and not killed:
                for rep, robj in zip(replicas, router.replicas):
                    if robj.inflight:
                        rep.kill()
                        killed.append(rep.name)
                release.set()
        assert killed, "no replica was carrying the stream"
        assert pages == setup["baseline_stream"], \
            "stream diverged across the replica kill (gap, dup, or " \
            "wrong tokens)"
        assert router.stats["stream_failovers"] >= 1
        survivor = next(r for r in replicas if r.alive)
        assert _wait_conserved(survivor.impl), "survivor leaked KV blocks"
    finally:
        release.set()
        del model.decode_step
        ch.close()
        router.close()
        for r in replicas:
            r.kill()


def test_router_infer_exactly_once_across_crash(setup):
    """Crash the replica executing a keyed Infer: the router resubmits
    to the survivor under the same key, the client gets exactly one
    bit-identical result, and a client-keyed retry replays from the
    router's dedup instead of re-executing."""
    replicas, router, ch = _router_setup(setup)
    iid = InferenceService.method("Infer").id
    try:
        key = router._affinity_key(setup["raw"])
        assert key is not None
        victim_rep = next(router._ring_order(key))
        victim = replicas[router.replicas.index(victim_rep)]
        survivor = next(r for r in replicas if r is not victim)

        results: "queue.Queue" = queue.Queue()

        def call():
            try:
                results.put(ch.call(iid, setup["raw"], timeout=CALL_S))
            except RpcError as e:
                results.put(e)

        threading.Thread(target=call, daemon=True).start()
        assert _wait(lambda: victim_rep.inflight), \
            "victim never received the call"
        victim.kill()
        out = results.get(timeout=CALL_S)
        assert not isinstance(out, Exception), out
        res = wire.decode(InferenceService.method("Infer").response,
                          bytes(out))
        assert bytes(bytearray(res["page"])) == setup["baseline_page"], \
            "failover produced different tokens"
        assert router.stats["failovers"] >= 1

        before = survivor.impl.batcher.stats["requests"]
        md = {IDEMPOTENCY_KEY: "chaos-keyed-1"}
        r1 = ch.call(iid, setup["raw"], metadata=dict(md), timeout=CALL_S)
        r2 = ch.call(iid, setup["raw"], metadata=dict(md), timeout=CALL_S)
        assert bytes(r1) == bytes(r2)
        assert survivor.impl.batcher.stats["requests"] - before == 1
        assert _wait_conserved(survivor.impl), "survivor leaked KV blocks"

        direct = Channel(survivor.dial())
        names = direct.typed(InferenceService).Stats({})["names"].split("\n")
        for k in ("server_conn_errors", "server_dedup_hits",
                  "server_dedup_evictions", "server_dedup_entries"):
            assert k in names, f"replica Stats missing {k}"
        direct.close()
    finally:
        ch.close()
        router.close()
        for r in replicas:
            r.kill()


def test_router_over_lossy_replica_links(setup):
    """The router's own links to its replicas under the chaos spec: a
    unary Infer and an InferStream through the router still return the
    fault-free baseline, and the replicas give every block back."""
    seed = FIXED_SEED

    def lossy(rep):
        # the replica's own server behind a faulty link (links made here
        # are not the replica's to sever: this test kills no replica)
        return _chaos_factory(rep.server, seed + int(rep.name[3:]) + 1)

    replicas, router, ch = _router_setup(
        setup, dial=lossy, policy=POLICY, attempt_timeout_s=ATTEMPT_TIMEOUT)
    try:
        inf = ch.typed(InferenceService)
        for _ in range(2):
            res = inf.Infer(dict(setup["req"]), timeout=CALL_S)
            assert bytes(bytearray(res["page"])) == setup["baseline_page"]
        pages = [bytes(bytearray(c["page"])) for c in inf.InferStream(
            dict(setup["req"]), timeout=CALL_S)]
        assert pages == setup["baseline_stream"]
        for r in replicas:
            assert _wait_conserved(r.impl), f"{r.name} leaked KV blocks"
    finally:
        ch.close()
        router.close()
        for r in replicas:
            r.kill()


# -- replica supervisor (stub processes, zero wall-clock) ---------------------

class _StubProc:
    def __init__(self):
        self.exit = None
        self.terminated = False

    def poll(self):
        return self.exit

    def terminate(self):
        self.terminated = True
        if self.exit is None:
            self.exit = 0

    def wait(self, timeout=None):
        return self.exit


def _stub_supervisor(count=2, **kw):
    spawned = []

    def spawn(i):
        h = _StubProc()
        spawned.append((i, h))
        return h

    kw.setdefault("policy", RetryPolicy(attempts=3, base_delay=1.0,
                                        multiplier=2.0, max_delay=8.0,
                                        jitter=0.0))
    sleeps = []
    clk = {"t": 0.0}
    kw.setdefault("sleep", sleeps.append)
    kw.setdefault("clock", lambda: clk["t"])
    kw.setdefault("on_event", lambda msg: None)
    sup = ReplicaSupervisor(spawn, count, **kw)
    # seed the slots without starting the monitor thread (tests drive
    # check() directly, deterministically)
    for i in range(count):
        sup.handles[i] = sup._spawn(i)
        sup._started_at[i] = clk["t"]
    return sup, spawned, sleeps, clk


def test_supervisor_restarts_with_capped_backoff():
    sup, spawned, sleeps, clk = _stub_supervisor(count=2)
    n0 = len(spawned)
    sup.handles[0].exit = 1          # replica 0 crashes
    sup.check()
    assert sup.failures == [1, 0] and sup.restarts == 1
    assert len(spawned) == n0 + 1
    assert sleeps[-1] == 1.0         # first restart: base delay
    # crash-loop: delays double, then cap at the policy's attempts index
    for expected in (2.0, 4.0, 4.0, 4.0):
        sup.handles[0].exit = 1
        sup.check()
        assert sleeps[-1] == expected
    assert sup.failures[0] == 5
    # stays up past stable_after_s: the crash history is forgiven
    clk["t"] += sup.stable_after_s + 1.0
    sup.check()
    assert sup.failures[0] == 0
    sup.handles[0].exit = 1          # next crash is cheap again
    sup.check()
    assert sleeps[-1] == 1.0


def test_supervisor_rolling_restart_and_stop():
    sup, spawned, sleeps, clk = _stub_supervisor(count=3)
    old = list(sup.handles)
    sup.rolling_restart(drain_timeout=1.0)
    assert all(h.terminated for h in old)
    assert all(new is not o for new, o in zip(sup.handles, old))
    assert sup.restarts == 3
    # after stop() a crashed replica is NOT respawned
    n = len(spawned)
    sup.stop(timeout=0.1)
    assert all(h.terminated for h in sup.handles)
    sup.handles[0].exit = 1
    sup.check()
    assert len(spawned) == n


def test_health_and_drain_complete_inflight(setup):
    """Drain on a dedicated server sharing the engine: Health answers
    while draining, in-flight Infer completes before shutdown."""
    engine, impl = setup["engine"], setup["impl"]
    server = build_server(engine, impl=impl)   # fresh server, same batcher
    ct, st = connected_pair()
    server.serve_transport(st, blocking=False)
    ch = Channel(ct)
    inf = ch.typed(InferenceService)
    h = inf.Health({"verbose": True})
    assert h["serving"] and not h["draining"]
    assert "names" in h  # verbose gauges present

    # enough concurrent calls that the batcher needs two waves; the
    # batcher's lock is held until all are in flight and the drain has
    # begun, so none can finish first
    n_calls = impl.batcher.max_batch + 1
    results: "queue.Queue" = queue.Queue()
    drained: "queue.Queue" = queue.Queue()
    impl.batcher._cond.acquire()
    try:
        for _ in range(n_calls):
            threading.Thread(
                target=lambda: results.put(
                    inf.Infer(dict(setup["req"]), timeout=CALL_S)),
                daemon=True).start()
        assert _wait(lambda: server.inflight >= n_calls)
        assert server.inflight == n_calls
        threading.Thread(target=lambda: drained.put(
            server.drain(timeout=CALL_S)), daemon=True).start()
        assert _wait(lambda: server.draining)
        # Health still answers while draining (drain-exempt), reports it
        h2 = inf.Health({})
        assert h2["draining"] and not h2["serving"]
        # new inference is refused while draining
        ct2, st2 = connected_pair()
        server.serve_transport(st2, blocking=False)
        ch2 = Channel(ct2)
        with pytest.raises(RpcError):
            ch2.typed(InferenceService).Infer(dict(setup["req"]),
                                              timeout=ARRIVE_S)
    finally:
        impl.batcher._cond.release()
    # every in-flight call completed with the right answer; drain waited
    for _ in range(n_calls):
        res = results.get(timeout=CALL_S)
        assert bytes(bytearray(res["page"])) == setup["baseline_page"]
    assert drained.get(timeout=CALL_S) is True
    ch.close()
    ch2.close()
