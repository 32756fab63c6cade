"""The port's Bebop RPC server and launcher against the JAX package's.

* **The bytes.**  The port's ``framing``, ``wire`` and ``fastwire`` copies
  encode the same bytes as the JAX modules for every message of
  ``InferenceService`` (and its method ids are the same 32 bits).
* **The service.**  All nine methods answer on the port's server, over
  ``InMemoryTransport`` and over TCP on 127.0.0.1.
* **Across packages.**  A JAX ``Channel`` against the port's server and the
  port's ``Channel`` against a JAX server give byte-identical response
  pages, greedy and seeded sampled (``n = 2`` included).
* **The protocol.**  An ``Infer`` -> ``ScorePage`` batch goes out as one
  frame and scores as two separate calls do; ``InferStream`` chunks joined
  together equal the ``Infer`` page; ``drain`` finishes the call in flight
  while ``Health`` answers and new work is refused.
* **The launcher.**  ``build_parser`` matches the JAX parser flag for
  flag; ``main([... "--once"], device="cpu")`` exits 0 after its probe.

Weights come from the JAX model (``params_from_numpy``) on
``reduced_config`` in float32; scores are held at 3e-5 / 1e-4.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core import fastwire as jfastwire
from repro.core import wire as jwire
from repro.core.rpc import Channel as JaxChannel
from repro.core.rpc import Frame as JaxFrame
from repro.core.rpc import TcpTransport as JaxTcpTransport
from repro.core.rpc import connected_pair as jax_connected_pair
from repro.core.rpc import encode_frame as jax_encode_frame
from repro.core.rpc import wire_types as JW
from repro.launch.serve import build_parser as jax_build_parser
from repro.serving import Engine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import build_server as jax_build_server
from repro.serving import service as jservice

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import fastwire, wire
from repro_torch.core.rpc import (Channel, Flags, Frame, ResilientChannel,
                                  RpcError, Status, TcpTransport,
                                  connected_pair, encode_frame)
from repro_torch.core.rpc import wire_types as W
from repro_torch.launch.serve import build_parser, main
from repro_torch.serving import (Engine, InferenceImpl, ServeConfig,
                                 build_server, decode_token_page,
                                 encode_gen_page, encode_prompt_page)
from repro_torch.serving import service

SC = dict(cache_len=96, max_new_tokens=12, prefill_chunk=8)
TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_reduced_config(jax_get_config("qwen2-1.5b"))
    cfg = reduced_config(get_config("qwen2-1.5b"))
    jengine = JaxEngine(jcfg, JaxServeConfig(**SC))
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jengine.params), device="cpu",
        dtype=torch.float32)
    engine = Engine(cfg, ServeConfig(**SC), params=params, device="cpu")
    return jengine, engine


@pytest.fixture(scope="module")
def servers(engines):
    """The port's and the JAX package's servers, each on TCP."""
    jengine, engine = engines
    impl = InferenceImpl(engine)
    server = build_server(engine, impl=impl)
    jserver = jax_build_server(jengine)
    addr = server.listen_tcp()[:2]
    jaddr = jserver.listen_tcp()[:2]
    yield server, addr, jserver, jaddr
    server.drain(timeout=5)
    jserver.drain(timeout=5)
    impl.close()


def _prompt(t=9, b=1, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, t)).astype(
        np.uint32)


# -- the bytes ----------------------------------------------------------------------

def _sample_messages(page):
    toks = np.arange(12, dtype=np.uint32)
    return {
        "TokenizeRequest": {"text": "héllo", "seq_len": 8},
        "TokenBatch": {"tokens": toks, "batch": 2, "seq_len": 6},
        "GenerateRequest": {"tokens": toks, "batch": 1, "seq_len": 12,
                            "max_new_tokens": 4, "stop_token": -1,
                            "temperature": 0.75, "top_k": 40,
                            "top_p": 0.9, "seed": 2 ** 32 - 1, "n": 3},
        "GenerateResponse": {"tokens": toks, "batch": 3, "new_tokens": 4},
        "TokenChunk": {"index": 3, "tokens": toks[:2],
                       "logprobs": [0.5, -1.25], "epoch": 2 ** 60 + 7},
        "ScoreResponse": {"scores": np.array([-1.5, 2.25], np.float32)},
        "InferRequest": {"page": page, "max_new_tokens": 6, "stop_token": 7,
                         "priority": -2, "ttft_slo_ms": 12.5,
                         "tpot_slo_ms": 3.0, "temperature": 0.8,
                         "top_k": 40, "top_p": 1.0, "seed": 5, "n": 2},
        "InferResponse": {"page": page, "batch": 1, "new_tokens": 9},
        "InferChunk": {"index": 0, "page": page, "epoch": 123},
        "StatsRequest": {"scope": ""},
        "StatsResponse": {"names": "a\nb", "values": np.array([1.0, 2.5])},
        "HealthRequest": {"verbose": True},
        "HealthResponse": {"serving": True, "draining": False, "inflight": 2,
                           "names": "x", "values": np.array([3.0]),
                           "epoch": 99},
    }


@pytest.mark.parametrize("name", [m.name for m in
                                  service.InferenceService.methods])
def test_method_messages_encode_the_same_bytes(name):
    page = encode_prompt_page(_prompt())
    assert page == jservice.encode_prompt_page(_prompt())
    m = service.InferenceService.method(name)
    jm = jservice.InferenceService.method(name)
    assert (m.id, m.kind) == (jm.id, jm.kind)
    msgs = _sample_messages(page)
    for t, jt in ((m.request, jm.request), (m.response, jm.response)):
        b = wire.encode(t, msgs[t.name])
        assert b == jwire.encode(jt, msgs[t.name]), t.name
        back = wire.decode(t, b)
        assert sorted(back) == sorted(jwire.decode(jt, b))
    frame = Frame(7, b"\x01\x02" + page[:40], Flags.END_STREAM
                  | Flags.CURSOR, cursor=41)
    assert encode_frame(frame) == jax_encode_frame(JaxFrame(
        7, b"\x01\x02" + page[:40], frame.flags, cursor=41))
    header = {"method_id": m.id, "metadata": {"idempotency-key": "k"},
              "cursor": 3}
    assert wire.encode(W.CallHeader, header) \
        == jwire.encode(JW.CallHeader, header)


@pytest.mark.parametrize("rows,width", [(1, 9), (3, 1), (2, 40)])
def test_fastwire_record_layouts_match(rows, width):
    toks = _prompt(t=width, b=rows, seed=width)
    for mk in ("prompt_record_struct", "gen_record_struct"):
        s, js = getattr(service, mk)(width), getattr(jservice, mk)(width)
        assert fastwire.static_dtype(s) == jfastwire.static_dtype(js)
    assert encode_gen_page(toks) == jservice.encode_gen_page(toks)
    np.testing.assert_array_equal(decode_token_page(encode_gen_page(toks)),
                                  toks)


# -- the service --------------------------------------------------------------------

def _connect(server, addr, transport):
    if transport == "tcp":
        return Channel(TcpTransport.connect(*addr))
    client, srv = connected_pair()
    server.serve_transport(srv, blocking=False)
    return Channel(client)


@pytest.mark.parametrize("transport", ["mem", "tcp"])
def test_all_nine_methods_answer(engines, servers, transport):
    jengine, engine = engines
    server, addr, _, _ = servers
    ch = _connect(server, addr, transport)
    try:
        inf = ch.typed(service.InferenceService)
        p = _prompt()
        tb = inf.Tokenize({"text": "hello bebop", "seq_len": 6})
        assert list(tb["tokens"]) == [ord(c) for c in "hello "]
        gen = inf.Generate({"tokens": p.reshape(-1), "batch": 1,
                            "seq_len": 9, "max_new_tokens": 5})
        want = jengine.generate(p.astype(np.int32), max_new_tokens=5)
        np.testing.assert_array_equal(np.asarray(gen["tokens"]),
                                      want.reshape(-1))
        chunks = list(inf.Stream({"tokens": p.reshape(-1), "batch": 1,
                                  "seq_len": 9, "max_new_tokens": 5}))
        assert [c["index"] for c in chunks] == list(range(5))
        np.testing.assert_array_equal(
            np.concatenate([c["tokens"] for c in chunks]), want.reshape(-1))
        sc = inf.Score({"tokens": p.reshape(-1), "batch": 1, "seq_len": 9})
        np.testing.assert_allclose(sc["scores"],
                                   jengine.score(p.astype(np.int32)), **TOL)
        res = inf.Infer({"page": encode_prompt_page(p), "max_new_tokens": 5})
        page = bytes(bytearray(res["page"]))
        assert page == jservice.encode_gen_page(want)
        ic = list(inf.InferStream({"page": encode_prompt_page(p),
                                   "max_new_tokens": 5}))
        assert len(ic) == 5
        sp = inf.ScorePage({"page": page})
        np.testing.assert_allclose(sp["scores"],
                                   jengine.score(want.astype(np.int32)),
                                   **TOL)
        st = inf.Stats({})
        names = st["names"].split("\n")
        assert "sampled_requests" in names and "ingest_pages" in names
        assert len(names) == len(st["values"])
        h = inf.Health({"verbose": True})
        assert h["serving"] and not h["draining"] and h["epoch"] > 0
        with pytest.raises(RpcError) as e:
            inf.Infer({"page": b"\x00" * 64})
        assert e.value.code == Status.INVALID_ARGUMENT
    finally:
        ch.close()


# -- across packages ----------------------------------------------------------------

def _cross_channel(chan_cls, pair, tcp_cls, server, addr, transport):
    """A channel of one package to a server of either, over TCP or over
    the client package's in-memory pair (its server end served by the
    other package's server)."""
    if transport == "tcp":
        return chan_cls(tcp_cls.connect(*addr))
    client, srv = pair()
    server.serve_transport(srv, blocking=False)
    return chan_cls(client)


@pytest.mark.parametrize("transport", ["mem", "tcp"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_clients_and_servers_of_both_packages_agree(servers, mode,
                                                    transport):
    """Every (client, server) pair of the two packages returns the same
    response page bytes for the same request."""
    server, addr, jserver, jaddr = servers
    extra = {} if mode == "greedy" else {"temperature": 0.8, "top_k": 40,
                                         "seed": 1234}
    reqs = [{"page": encode_prompt_page(_prompt(t=11, seed=3)),
             "max_new_tokens": 7, **extra},
            {"page": encode_prompt_page(_prompt(t=6, b=2, seed=4)), **extra}]
    if mode == "sampled":
        reqs.append({"page": encode_prompt_page(_prompt(t=8, seed=5)),
                     "max_new_tokens": 6, "n": 2, **extra})
    pages = []
    for chan_cls, pair, tcp_cls, svc in (
            (Channel, connected_pair, TcpTransport, service),
            (JaxChannel, jax_connected_pair, JaxTcpTransport, jservice)):
        for srv, a in ((server, addr), (jserver, jaddr)):
            ch = _cross_channel(chan_cls, pair, tcp_cls, srv, a, transport)
            try:
                inf = ch.typed(svc.InferenceService)
                pages.append([bytes(bytearray(inf.Infer(r)["page"]))
                              for r in reqs])
                if mode == "sampled":
                    g = inf.Generate({"tokens": _prompt().reshape(-1),
                                      "batch": 1, "seq_len": 9,
                                      "max_new_tokens": 5, "n": 2, **extra})
                    pages[-1].append(np.asarray(g["tokens"]).tobytes())
            finally:
                ch.close()
    assert all(p == pages[0] for p in pages[1:])
    assert all(len(p) for p in pages[0])
    if mode == "sampled":
        assert decode_token_page(pages[0][2]).shape == (2, 6)


# -- the protocol -------------------------------------------------------------------

def test_infer_then_scorepage_batch_is_one_round_trip(servers):
    server, _, _, _ = servers
    client, srv = connected_pair()
    server.serve_transport(srv, blocking=False)
    sent = []
    send = client.send
    client.send = lambda data: (sent.append(len(data)), send(data))[1]
    ch = Channel(client)
    try:
        req = {"page": encode_prompt_page(_prompt(t=10, b=2, seed=8)),
               "max_new_tokens": 6}
        iid = service.InferenceService.method("Infer").id
        sid = service.InferenceService.method("ScorePage").id
        res = ch.batch([
            {"method_id": iid,
             "payload": wire.encode(service.InferRequest, req)},
            {"method_id": sid, "input_from": 0}])
        assert len(sent) == 1
        assert [r["status"] for r in res] == [Status.OK] * 2
        batched = wire.decode(service.ScoreResponse, res[1]["payload"])
        inf = ch.typed(service.InferenceService)
        page = bytes(bytearray(inf.Infer(req)["page"]))
        alone = inf.ScorePage({"page": page})
        assert wire.decode(service.InferResponse, res[0]["payload"])[
            "page"].tobytes() == page
        np.testing.assert_allclose(batched["scores"], alone["scores"], **TOL)
    finally:
        ch.close()


def test_inferstream_chunks_join_to_the_infer_page(servers):
    server, addr, _, _ = servers
    ch = _connect(server, addr, "tcp")
    try:
        inf = ch.typed(service.InferenceService)
        for extra in ({}, {"temperature": 0.9, "top_k": 40, "seed": 77}):
            req = {"page": encode_prompt_page(_prompt(t=7, b=2, seed=9)),
                   "max_new_tokens": 8, **extra}
            page = bytes(bytearray(inf.Infer(req)["page"]))
            chunks = list(inf.InferStream(req))
            assert [c["index"] for c in chunks] == list(range(8))
            joined = np.concatenate(
                [decode_token_page(bytes(bytearray(c["page"])))
                 for c in chunks], axis=1)
            assert encode_gen_page(joined) == page
        resumed = list(ch.call(service.InferenceService.method(
            "InferStream").id, wire.encode(service.InferRequest, req),
            server_stream=True, cursor=5))
        tail = [decode_token_page(bytes(bytearray(wire.decode(
            service.InferChunk, it.payload)["page"]))) for it in resumed]
        np.testing.assert_array_equal(np.concatenate(tail, axis=1),
                                      joined[:, 5:])
    finally:
        ch.close()


def test_resilient_channel_reconnects_and_resumes(servers):
    """The port's ``ResilientChannel`` (under the copied ``RetryPolicy``)
    against the port's server: a unary call after the wire died redials
    and returns the same page; a stream cut mid-way resumes from its
    cursor without a gap or a duplicate."""
    _, addr, _, _ = servers
    live = []

    def dial():
        live.append(TcpTransport.connect(*addr))
        return live[-1]

    rc = ResilientChannel(dial)
    try:
        inf = rc.typed(service.InferenceService)
        req = {"page": encode_prompt_page(_prompt(t=7, seed=12)),
               "max_new_tokens": 6}
        first = bytes(bytearray(inf.Infer(req)["page"]))
        live[-1].close()
        assert bytes(bytearray(inf.Infer(req)["page"])) == first
        assert rc.reconnects >= 1
        it = inf.InferStream(req)
        got = [next(it), next(it)]
        live[-1].close()
        got += list(it)
        assert [c["index"] for c in got] == list(range(6))
        joined = np.concatenate([decode_token_page(bytes(bytearray(
            c["page"]))) for c in got], axis=1)
        assert encode_gen_page(joined) == first
    finally:
        rc.close()


def test_drain_finishes_inflight_and_answers_health(engines):
    _, engine = engines
    impl = InferenceImpl(engine)
    server = build_server(engine, impl=impl)
    addr = server.listen_tcp()[:2]
    ch = _connect(server, addr, "tcp")
    inf = ch.typed(service.InferenceService)
    out, done = {}, {}
    try:
        impl.batcher._cond.acquire()     # hold the scheduler: Infer waits
        try:
            t = threading.Thread(target=lambda: out.update(inf.Infer(
                {"page": encode_prompt_page(_prompt()),
                 "max_new_tokens": 4})))
            t.start()
            end = time.monotonic() + 30
            while server.inflight < 1 and time.monotonic() < end:
                time.sleep(0.01)
            assert server.inflight == 1
            d = threading.Thread(target=lambda: done.update(
                ok=server.drain(timeout=60)))
            d.start()
            while not server.draining:
                time.sleep(0.01)
            h = inf.Health({})
            # in flight: the held Infer and this Health call itself
            assert h["draining"] and not h["serving"] and h["inflight"] == 2
            with pytest.raises(RpcError) as e:
                inf.Generate({"tokens": _prompt().reshape(-1), "batch": 1,
                              "seq_len": 9})
            assert e.value.code == Status.UNAVAILABLE
        finally:
            impl.batcher._cond.release()
        t.join(timeout=60)
        d.join(timeout=60)
        assert not t.is_alive() and not d.is_alive()
        assert done["ok"] and out["new_tokens"] == 4
    finally:
        ch.close()
        impl.close()


# -- the launcher -------------------------------------------------------------------

def test_parser_matches_jax_flag_for_flag():
    def flags(p):
        return sorted((a.dest, repr(a.default), tuple(a.option_strings))
                      for a in p._actions)
    assert flags(build_parser()) == flags(jax_build_parser())


def test_launch_once_serves_a_probe_and_exits_zero(capsys):
    argv = ["--arch", "qwen2-1.5b", "--once", "--block-size", "8",
            "--prefill-chunk", "16"]
    assert main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "(paged KV cache, cpu)" in out
    assert "probe generated 4 tokens" in out
    with pytest.raises(NotImplementedError, match="item 8"):
        main(["--arch", "qwen2-1.5b", "--replicas", "2"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)          # the card by default, and no fallback
