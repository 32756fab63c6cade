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
* **The transports.**  ``Http1Transport`` puts the JAX transport's bytes
  on the wire (requests, responses, error statuses), parses the same
  streams the same way, and the ``bebop-deadline`` header is the JAX
  form; a client of either package over HTTP/1.1 on TCP talks to a server
  of either.  ``FaultInjectingTransport`` with one seed, or one
  ``script``, damages, drops and cuts the same frames as the JAX one.
* **The launcher.**  ``build_parser`` matches the JAX parser flag for
  flag; ``main([... "--once"], device="cpu")`` exits 0 after its probe,
  with one replica and with ``--replicas 2`` (both children on the CPU,
  behind the router); a child's argv carries every flag of the JAX
  launcher's ``_child_argv``, and a child asked for the card where there
  is none exits at startup.

Weights come from the JAX model (``params_from_numpy``) on
``reduced_config`` in float32; scores are held at 3e-5 / 1e-4.
"""
import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core import fastwire as jfastwire
from repro.core import wire as jwire
from repro.core.rpc import Channel as JaxChannel
from repro.core.rpc import Deadline as JaxDeadline
from repro.core.rpc import FaultInjectingTransport as JaxFaultTransport
from repro.core.rpc import FaultSpec as JaxFaultSpec
from repro.core.rpc import FramingError as JaxFramingError
from repro.core.rpc import Http1Transport as JaxHttp1Transport
from repro.core.rpc import Frame as JaxFrame
from repro.core.rpc import TcpTransport as JaxTcpTransport
from repro.core.rpc import connected_pair as jax_connected_pair
from repro.core.rpc import encode_frame as jax_encode_frame
from repro.core.rpc import wire_types as JW
from repro.launch import serve as jax_serve
from repro.launch.serve import build_parser as jax_build_parser
from repro.serving import Engine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import build_server as jax_build_server
from repro.serving import service as jservice

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import fastwire, wire
from repro_torch.core.rpc import (Channel, Deadline, FaultInjectingTransport,
                                  FaultSpec, Flags, Frame, FramingError,
                                  Http1Transport, ResilientChannel, RpcError,
                                  Status, TcpTransport, connected_pair,
                                  encode_frame)
from repro_torch.core.rpc import wire_types as W
from repro_torch.launch import serve
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


def test_drain_ends_the_accept_thread(engines):
    """A drained server's accept thread ends, so nothing keeps the server
    (its handlers, their engine and KV pool) alive: closing a listening
    socket alone leaves the thread blocked in ``accept()`` on Linux."""
    _, engine = engines
    impl = InferenceImpl(engine)
    server = build_server(engine, impl=impl)
    before = set(threading.enumerate())
    server.listen_tcp()
    accept = [t for t in threading.enumerate()
              if t not in before and t.name == "bebop-rpc-accept"]
    assert len(accept) == 1
    time.sleep(0.2)     # the thread blocks in accept()
    try:
        assert server.drain(timeout=30)
        accept[0].join(timeout=10)
        assert not accept[0].is_alive()
    finally:
        impl.close()
    ref = weakref.ref(server)
    del server, impl
    gc.collect()
    assert ref() is None


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
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)          # the card by default, and no fallback


def test_launch_replicas_once_runs_children_on_the_callers_device(
        monkeypatch, capsys):
    """``--replicas 2 --once``: two children on the caller's device behind
    the router, one probe through it, exit 0; a child asked for the card
    where there is none exits at startup and the launcher raises."""
    spawned = []
    spawn = serve._spawn_child

    def spy(argv):
        spawned.append(argv)
        return spawn(argv)

    monkeypatch.setattr(serve, "_spawn_child", spy)
    argv = ["--arch", "qwen2-1.5b", "--replicas", "2", "--once",
            "--block-size", "8", "--prefill-chunk", "16"]
    assert main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "(router, 2 replicas, cpu)" in out
    assert "probe generated 4 tokens via router" in out
    assert len(spawned) == 2
    assert all(a[1] == "-c" and "device='cpu'" in a[2] for a in spawned)
    if not torch.cuda.is_available():
        spawned.clear()
        with pytest.raises(RuntimeError, match="exited during startup"):
            main(argv)          # the children default to the card too
        assert len(spawned) == 1 and "device='cuda'" in spawned[0][2]


@pytest.mark.parametrize("extra", [[], ["--blocking-prefill", "--dense-cache",
                                        "--full", "--no-prefix-cache",
                                        "--no-spec-decode", "--no-swap",
                                        "--temperature", "0.7", "--seed",
                                        "9"]])
def test_child_argv_carries_every_jax_flag(extra):
    argv = ["--arch", "gemma-2b", "--replicas", "3", "--cache-len", "77",
            "--max-step-tokens", "5", "--top-k", "4"] + extra
    got = serve._child_argv(build_parser().parse_args(argv), "cpu")
    want = jax_serve._child_argv(jax_build_parser().parse_args(argv))
    assert want[1:3] == ["-m", "repro.launch.serve"]
    assert got[1] == "-c" and got[3:] == want[3:]


# -- the transports -----------------------------------------------------------------

class _Wire:
    """Inner transport that records what is sent and replays ``chunks``."""

    def __init__(self, chunks=()):
        self.sent = []
        self.chunks = list(chunks)
        self.closed = False

    def send(self, data):
        self.sent.append(bytes(data))

    def recv(self, timeout=None):
        return self.chunks.pop(0) if self.chunks else b""

    def close(self):
        self.closed = True

    @property
    def peer(self):
        return "wire"


def _http_sends(cls):
    c, srv = _Wire(), _Wire()
    client, server = cls(c, client=True), cls(srv, client=False)
    client.send(b"\x01frame-bytes")
    client.send(b"")
    server.send(b"\x02response" * 3)
    for code in range(17):
        server.send_error(code, b"why")
    server.send_error(200, b"")           # an application code
    return c.sent + srv.sent


def test_http1_bytes_match_jax():
    assert _http_sends(Http1Transport) == _http_sends(JaxHttp1Transport)
    d = Deadline.after(3.5)
    header = d.to_http_header()
    assert header == JaxDeadline(d.ts).to_http_header()
    assert Deadline.from_http_header(header).cutoff_ns() == \
        JaxDeadline.from_http_header(header).cutoff_ns()


@pytest.mark.parametrize("stream", [
    [b"POST /bebop HTTP/1.1\r\ncontent-length: 5\r\n\r\nfirst"
     b"HTTP/1.1 200 OK\r\ncontent-length: 6\r\n\r\nsecond"],
    [b"HTTP/1.1 503 Error\r\nbebop-status: 14\r\ncontent-len",
     b"gth: 3\r\n\r\nwh", b"y"],
    [b"POST / HTTP/1.1\r\ncontent-length: 999999999999\r\n\r\n"],
    [b"POST / HTTP/1.1\r\ncontent-length: two\r\n\r\n"],
    [b"X" * 70000],
    [b"POST / HTTP/1.1\r\ncontent-length: 10\r\n\r\nshort"]])
def test_http1_parses_streams_as_jax_does(stream):
    def bodies(cls, err):
        t = cls(_Wire(stream), client=False)
        out = []
        for _ in range(3):
            try:
                out.append(t.recv(timeout=1.0))
            except err as e:
                out.append(("FramingError", str(e)))
                break
        return out
    assert bodies(Http1Transport, FramingError) == \
        bodies(JaxHttp1Transport, JaxFramingError)


def _http_tcp_pair(client_tcp, client_http, server, server_tcp, server_http):
    """A TCP connection on 127.0.0.1 with an HTTP/1.1 envelope on each
    end: the client end from one package, the server end served by
    ``server`` through the other's."""
    import socket
    lsock = socket.create_server(("127.0.0.1", 0))
    try:
        client = client_tcp.connect(*lsock.getsockname()[:2])
        conn, _ = lsock.accept()
    finally:
        lsock.close()
    server.serve_transport(server_http(server_tcp(conn), client=False),
                           blocking=False)
    return client_http(client, client=True)


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_http1_clients_and_servers_of_both_packages_agree(servers,
                                                          client_pkg,
                                                          server_pkg):
    """Over HTTP/1.1 on TCP, every (client, server) pair returns the page
    and the stream chunks that the binary TCP transport returns."""
    server, addr, jserver, _ = servers
    req = {"page": encode_prompt_page(_prompt(t=10, seed=14)),
           "max_new_tokens": 5}
    ch = _connect(server, addr, "tcp")
    try:
        inf = ch.typed(service.InferenceService)
        want = bytes(bytearray(inf.Infer(req)["page"]))
        want_chunks = [bytes(bytearray(c["page"])) for c in
                       inf.InferStream(req)]
    finally:
        ch.close()
    port_side = (TcpTransport, Http1Transport, Channel,
                 service.InferenceService)
    jax_side = (JaxTcpTransport, JaxHttp1Transport, JaxChannel,
                jservice.InferenceService)
    ctcp, chttp, chan, svc = port_side if client_pkg == "port" else jax_side
    stcp, shttp, _, _ = port_side if server_pkg == "port" else jax_side
    srv = server if server_pkg == "port" else jserver
    ch = chan(_http_tcp_pair(ctcp, chttp, srv, stcp, shttp))
    try:
        inf = ch.typed(svc)
        assert bytes(bytearray(inf.Infer(req)["page"])) == want
        assert [bytes(bytearray(c["page"])) for c in inf.InferStream(req)] \
            == want_chunks
    finally:
        ch.close()


def _faults(cls, spec_cls, frames, **kw):
    """What the inner wire received, and what each send raised, for one
    wrapper fed ``frames``."""
    inner = _Wire()
    t = cls(inner, spec_cls(drop=0.15, truncate=0.15, corrupt=0.15,
                            delay=0.15, delay_s=0.0), **kw)
    raised = []
    for f in frames:
        try:
            t.send(f)
            raised.append(None)
        except ConnectionError as e:
            raised.append(str(e))
    return inner.sent, raised, dict(t.injected), inner.closed


@pytest.mark.parametrize("kw", [{"seed": s} for s in (0, 1, 7, 20240808)]
                         + [{"seed": 3, "script": {0: "delay", 1: "drop",
                                                   2: "truncate"}},
                            {"seed": 4, "script": {1: "corrupt"}},
                            {"seed": 5, "script": {2: "disconnect"}}])
def test_fault_transport_damages_the_same_bytes_as_jax(kw):
    frames = [encode_frame(Frame(i + 1, bytes(range(i % 7, 40 + i))))
              for i in range(24)] + [b"\x01", b""]
    # a cut line stops the wrapper: send each frame to a fresh wrapper
    # too, so every draw of the seeded schedule is compared
    got = _faults(FaultInjectingTransport, FaultSpec, frames, **kw)
    assert got == _faults(JaxFaultTransport, JaxFaultSpec, frames, **kw)
    assert sum(got[2].values()) > 0
    for i in range(0, len(frames), 5):
        assert _faults(FaultInjectingTransport, FaultSpec, frames[i:],
                       **kw) == _faults(JaxFaultTransport, JaxFaultSpec,
                                        frames[i:], **kw)
