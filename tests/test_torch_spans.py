"""The port's span recorder (``repro_torch/utils/spans.py``) on the served
path: a tiny paged qwen2 behind ``build_server`` on loopback, on the CPU.

Off, it records nothing and the tokens and batcher stats are those of a
run with it on.  On, one ``Infer``'s spans share a request id and nest as
the sites say, children lie inside their parents, every ``batcher.step``
has exactly one span of each phase, and the steps' counts add up to the
batcher's own counters over the same window.  A span maps onto
``torch.profiler``'s clock through the pair ``drain()`` returns, and the
ring counts what it dropped.  With the recorder off, a profiler that
traces every thread sees the worker's admission and step phases as
host ranges of the spans' names."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.rpc import Channel, TcpTransport
from repro_torch.serving import (Engine, InferenceImpl, ServeConfig,
                                 build_server, decode_token_page,
                                 encode_prompt_page)
from repro_torch.serving import service
from repro_torch.serving.engine import _StepTrace
from repro_torch.utils import spans

SC = dict(cache_len=96, max_new_tokens=10, prefill_chunk=8, max_batch=4)
# widths 5-40 over a chunk of 8: chunked and mixed prefill; the first,
# second and fourth share a 16-token prefix (the prefix cache)
WIDTHS = (21, 30, 5, 40, 12, 9)


@pytest.fixture(scope="module")
def engine():
    return Engine(reduced_config(get_config("qwen2-1.5b")), ServeConfig(**SC),
                  device="cpu")


@pytest.fixture(autouse=True)
def recorder_off():
    spans.drain()
    yield
    spans.drain()


def _prompts():
    rng = np.random.default_rng(7)
    head = rng.integers(0, 512, 16)
    out = []
    for i, t in enumerate(WIDTHS):
        p = rng.integers(0, 512, t)
        if i in (0, 1, 3):
            p[:16] = head
        out.append(p.astype(np.uint32)[None])
    return out


class Served:
    """A fresh batcher and server over ``engine``, and a client."""

    def __init__(self, engine):
        self.impl = InferenceImpl(engine)
        self.server = build_server(engine, impl=self.impl)
        host, port, _ = self.server.listen_tcp()
        self.ch = Channel(TcpTransport.connect(host, port))
        self.inf = self.ch.typed(service.InferenceService)

    def infer(self, prompt):
        got = self.inf.Infer({"page": encode_prompt_page(prompt),
                              "max_new_tokens": 8})
        return decode_token_page(bytes(bytearray(got["page"])))

    def idle(self, timeout=60.0):
        """Wait until the worker has recorded its last step and every
        handler its ``rpc.handler`` span (a client has its reply before
        the handler thread leaves the span)."""
        b = self.impl.batcher
        end = time.monotonic() + timeout
        while (b._active or b._queue or b._trace is not None
               or self.server.inflight) and time.monotonic() < end:
            time.sleep(0.005)
        assert not b._active and b._trace is None
        assert self.server.inflight == 0

    def close(self):
        self.ch.close()
        self.server.drain(timeout=10)
        self.impl.close()


def _served_in_turn(engine, on):
    s = Served(engine)
    try:
        if on:
            spans.enable()
        toks = [s.infer(p) for p in _prompts()]
        s.idle()
        got = spans.drain()
        return toks, dict(s.impl.batcher.stats), got
    finally:
        s.close()


def test_off_records_nothing_and_changes_nothing(engine, monkeypatch):
    called = []
    with monkeypatch.context() as m:
        for name in ("now", "add", "scope", "new_request", "current_request"):
            m.setattr(spans, name, lambda *a, _n=name, **k: called.append(_n))
        toks_off, stats_off, got_off = _served_in_turn(engine, on=False)
    assert called == [], "a site did work while the recorder was off"
    toks_on, stats_on, got_on = _served_in_turn(engine, on=True)
    assert got_off["spans"] == [] and got_off["dropped"] == 0
    assert {s.name for s in got_on["spans"]} >= {
        "rpc.queued", "rpc.handler", "ingest.admit", "ingest.to_host",
        "batcher.queued", "batcher.admit", "batcher.step",
        *_StepTrace.PHASES}
    assert stats_off["mixed_steps"] > 0 and stats_off["spec_steps"] > 0
    assert stats_off["prefix_hits"] > 0
    assert stats_on == stats_off
    for a, b in zip(toks_on, toks_off):
        np.testing.assert_array_equal(a, b)


def _inside(child, parent):
    return parent.start <= child.start <= child.end <= parent.end


@pytest.fixture(scope="module")
def burst(engine):
    """Twelve Infer calls at once (three times ``max_batch``), spans on;
    the batcher's stats before and after, and what the recorder kept."""
    s = Served(engine)
    try:
        s.idle()
        stats0 = dict(s.impl.batcher.stats)
        spans.enable()
        prompts = _prompts() * 2
        out = [None] * len(prompts)

        def call(i):
            out[i] = s.infer(prompts[i])
        ths = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in ths)
        s.idle()
        got = spans.drain()
        stats1 = dict(s.impl.batcher.stats)
    finally:
        spans.drain()
        s.close()
    assert all(o is not None and o.shape == (1, 8) for o in out)
    return stats0, stats1, got


def test_one_infer_shares_a_request_id_and_nests(burst):
    _, _, got = burst
    assert got["dropped"] == 0
    handlers = [s for s in got["spans"] if s.name == "rpc.handler"
                and s.attrs["method"] == "Infer"]
    assert len(handlers) == 12
    by_req = {}
    for s in got["spans"]:
        if s.request:
            by_req.setdefault(s.request, []).append(s)
    for h in handlers:
        mine = {s.name: s for s in by_req[h.request]}
        assert sorted(s.name for s in by_req[h.request]) == sorted(mine)
        assert set(mine) == {"rpc.queued", "rpc.handler", "ingest.admit",
                             "ingest.to_host", "batcher.queued"}
        assert mine["rpc.queued"].parent == 0 and h.parent == 0
        assert mine["rpc.queued"].attrs == {"method": "Infer"}
        assert mine["rpc.queued"].end <= h.start
        for name in ("ingest.admit", "ingest.to_host"):
            assert mine[name].parent == h.id
            assert _inside(mine[name], h)
            assert mine[name].thread == h.thread
        assert mine["ingest.admit"].end <= mine["ingest.to_host"].start
        q = mine["batcher.queued"]
        assert _inside(q, h) and q.thread == "serve-paged-batcher"
        assert q.start >= mine["ingest.to_host"].end
        assert q.attrs["rows"] == 1
        assert q.attrs["prompt_tokens"] in WIDTHS
        assert mine["ingest.admit"].attrs == {
            "records": 1, "bytes": 4 * q.attrs["prompt_tokens"]}


def test_every_step_has_one_span_of_each_phase(burst):
    _, _, got = burst
    steps = {s.id: s for s in got["spans"] if s.name == "batcher.step"}
    kids = {}
    for s in got["spans"]:
        if s.name in _StepTrace.PHASES:
            kids.setdefault(s.parent, []).append(s)
    assert steps and set(kids) == set(steps)
    for sid, step in steps.items():
        phases = sorted(kids[sid], key=lambda s: s.start)
        assert [s.name for s in phases] == list(_StepTrace.PHASES)
        assert phases[0].start == step.start and phases[-1].end == step.end
        for a, b in zip(phases, phases[1:]):
            assert a.end == b.start
        assert all(_inside(s, step) for s in phases)
        a = step.attrs
        assert a["kind"] in ("mixed", "verify", "decode")
        used = a["decode_rows"] + a["prefill_rows"]
        assert 0 < used <= SC["max_batch"]
        assert used <= a["q_tokens"] <= a["q_positions"]
        assert a["q_positions"] % SC["max_batch"] == 0
        assert a["ctx_tokens"] >= a["q_tokens"]
        # step.logits: a greedy burst picks every real row on the card
        # and brings only the ids across, [max_batch] or a verify step's
        # [max_batch, C] int32
        lg = phases[2].attrs
        assert lg["host_rows"] == 0 and lg["device_rows"] == used
        width = a["q_positions"] // SC["max_batch"] \
            if a["kind"] == "verify" else 1
        assert lg["bytes"] == SC["max_batch"] * width * 4


def test_step_spans_add_up_to_the_batchers_counters(burst):
    stats0, stats1, got = burst

    def delta(k):
        return stats1[k] - stats0[k]
    steps = [s for s in got["spans"] if s.name == "batcher.step"]
    kinds = [s.attrs["kind"] for s in steps]
    assert sum(s.attrs["decode_rows"] for s in steps) == delta("batched_rows")
    assert kinds.count("mixed") == delta("mixed_steps")
    assert kinds.count("verify") == delta("spec_steps")
    assert sum(1 for s in steps if s.attrs["decode_rows"]) \
        == delta("decode_steps")
    # every row a step ran was picked on the card: each decoding row, and
    # each one-row request's prefill chunk
    logits = {s.parent: s.attrs for s in got["spans"]
              if s.name == "step.logits"}
    assert sum(logits[s.id]["device_rows"] for s in steps) \
        == delta("batched_rows") + delta("prefill_chunks")
    assert all(logits[s.id]["host_rows"] == 0 for s in steps)
    admits = [s for s in got["spans"] if s.name == "batcher.admit"]
    assert sum(s.attrs["installed"] for s in admits) == delta("requests")
    pf = [s for s in steps if s.attrs["kind"] == "mixed"]
    # a mixed step's real tokens: one a decoding row, a chunk's worth at
    # most for each prefilling row
    for s in pf:
        a = s.attrs
        assert a["q_tokens"] <= a["decode_rows"] \
            + a["prefill_rows"] * SC["prefill_chunk"]


def test_a_span_maps_onto_the_profilers_clock(engine):
    impl = InferenceImpl(engine)
    try:
        impl._ensure_plan(40)
        page = encode_prompt_page(_prompts()[3])
        spans.enable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm-up"):   # the first range pays set-up
                pass
            with record_function("probe.admit"):
                impl.ingest.admit(page)
        got = spans.drain()
    finally:
        impl.close()
    (span,) = [s for s in got["spans"] if s.name == "ingest.admit"]
    mono, wall = got["clock"]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe.admit"]
    assert abs(span.start - mono + wall - ev.start_ns()) < 1_000_000
    assert abs(span.end - mono + wall - ev.start_ns() - ev.duration_ns()) \
        < 1_000_000


def test_the_profiler_sees_the_steps_phases_with_the_recorder_off(engine):
    try:
        from torch._C._profiler import _ExperimentalConfig
        extra = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pytest.skip("this torch cannot profile every thread")
    s = Served(engine)
    try:
        s.idle()
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=extra) as prof:
            s.infer(_prompts()[3])
            s.idle()
    finally:
        s.close()
    assert not spans.on and spans.drain()["spans"] == []
    got = {n: [] for n in ("batcher.wait", "batcher.admit", "batcher.step",
                           *_StepTrace.PHASES)}
    for e in prof.profiler.kineto_results.events():
        if e.name() in got:
            got[e.name()].append((e.start_ns(),
                                  e.start_ns() + e.duration_ns(), e.name()))
    assert got["batcher.wait"] and got["batcher.admit"] and got["batcher.step"]
    assert len(got["step.assemble"]) == len(got["batcher.step"])
    # each step holds its phases in order, all five once it reached the
    # device (a step with nothing to run holds step.assemble alone)
    reached = 0
    for a, b, _ in got["batcher.step"]:
        inside = sorted((s0, n) for n in _StepTrace.PHASES
                        for s0, e0, _ in got[n] if a <= s0 and e0 <= b)
        names = [n for _, n in inside]
        assert names in (list(_StepTrace.PHASES), ["step.assemble"])
        reached += len(names) == len(_StepTrace.PHASES)
    assert reached > 0
    assert all(len(got[n]) == reached for n in _StepTrace.PHASES[1:])


def test_the_ring_keeps_the_newest_and_counts_the_dropped():
    spans.enable(capacity=4)
    for i in range(10):
        spans.add("x", spans.now(), i=i)
    got = spans.drain()
    assert [s.attrs["i"] for s in got["spans"]] == [6, 7, 8, 9]
    assert got["dropped"] == 6
    assert not spans.on
    spans.add("late", spans.now())      # a site that raced the drain
    got = spans.drain()
    assert got["spans"] == [] and got["dropped"] == 0


def test_scopes_nest_and_carry_their_request():
    spans.enable()
    with spans.scope("outer", spans.new_request()) as outer:
        rid = spans.current_request()
        with spans.scope("inner") as inner:
            spans.add("leaf", spans.now())
    assert spans.current_request() == 0
    got = {s.name: s for s in spans.drain()["spans"]}
    assert got["outer"].id == outer and got["inner"].id == inner
    assert got["inner"].parent == outer and got["leaf"].parent == inner
    assert {s.request for s in got.values()} == {rid} and rid > 0
    assert _inside(got["leaf"], got["inner"])
    assert _inside(got["inner"], got["outer"])
