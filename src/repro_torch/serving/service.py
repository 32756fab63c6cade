"""The inference service: the paper's RPC protocol carrying the engine.

A port of the JAX package's ``serving/service.py``.  Service definition:

    service Inference {
      Tokenize(TokenizeRequest): TokenBatch;       // embed text -> ids (stub)
      Generate(GenerateRequest): GenerateResponse; // unary generation
      Stream(GenerateRequest): stream TokenChunk;  // cursor-resumable stream
      Score(TokenBatch): ScoreResponse;            // logprob scoring
      Infer(InferRequest): InferResponse;          // page in, page out
      InferStream(InferRequest): stream InferChunk;// page-encoded streaming
      ScorePage(InferResponse): ScoreResponse;     // score a token page
      Stats(StatsRequest): StatsResponse;          // scheduler counters
      Health(HealthRequest): HealthResponse;       // liveness + drain state
    }

The messages, method ids and page records are the JAX package's, byte for
byte, so a client of either package talks to a server of either.  ``Infer``
and ``InferStream`` take a Bebop *page* of fixed-layout prompt records: the
handler validates the header, places the raw bytes on the engine's device
and the ``bebop_decode`` CUDA kernel materializes the token matrix
(serving/ingest.py); generation runs under the batcher (serving/engine.py),
and the response is itself a fixed-layout page.  ``Generate``, ``Stream``
and ``InferStream`` run :meth:`Engine.generate` directly (streams flush each
token as its decode step finishes); every generation handler takes the
sampling fields through :class:`GenerationParams`.

Handlers run on the server's executor threads while the batcher's worker
runs steps; every tensor a handler places names the engine's device.
:meth:`InferenceImpl.infer` and :meth:`InferenceImpl.score_page` call the
``Infer`` and ``ScorePage`` handlers in process, without a server.
"""
from __future__ import annotations

import concurrent.futures as _cf
import queue as _queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np

from ..core import fastwire, pages
from ..core import types as T
from ..core.rpc import (IDEMPOTENCY_KEY, Router, RpcContext, RpcError,
                        Server, Status)
from ..core.schema import MethodDef, ServiceDef
from ..utils import spans
from .engine import ContinuousBatcher, Engine, PagedBatcher, ShedError
from .ingest import PageIngest
from .sampling import GenerationParams, SamplingParams

# -- wire types ----------------------------------------------------------------

TokenizeRequest = T.Message("TokenizeRequest", [
    T.Field("text", T.STRING, tag=1),
    T.Field("seq_len", T.UINT32, tag=2),
])

TokenBatch = T.Message("TokenBatch", [
    T.Field("tokens", T.Array(T.UINT32), tag=1),   # flattened
    T.Field("batch", T.UINT32, tag=2),
    T.Field("seq_len", T.UINT32, tag=3),
])

GenerateRequest = T.Message("GenerateRequest", [
    T.Field("tokens", T.Array(T.UINT32), tag=1),
    T.Field("batch", T.UINT32, tag=2),
    T.Field("seq_len", T.UINT32, tag=3),
    T.Field("max_new_tokens", T.UINT32, tag=4),
    T.Field("stop_token", T.INT32, tag=5),
    # sampling tier (absent -> ServeConfig defaults; temperature 0 =
    # greedy; n > 1 = parallel candidates of a single-row prompt) —
    # semantics in serving/sampling.py:GenerationParams
    T.Field("temperature", T.FLOAT32, tag=6),
    T.Field("top_k", T.UINT32, tag=7),
    T.Field("top_p", T.FLOAT32, tag=8),
    T.Field("seed", T.UINT32, tag=9),
    T.Field("n", T.UINT32, tag=10),
])

GenerateResponse = T.Message("GenerateResponse", [
    T.Field("tokens", T.Array(T.UINT32), tag=1),
    T.Field("batch", T.UINT32, tag=2),
    T.Field("new_tokens", T.UINT32, tag=3),
])

TokenChunk = T.Message("TokenChunk", [
    T.Field("index", T.UINT32, tag=1),
    T.Field("tokens", T.Array(T.UINT32), tag=2),
    T.Field("logprobs", T.Array(T.BFLOAT16), tag=3),
    # producing process's epoch: a consumer resuming by cursor checks it
    # to reject silent resumption into a restarted process (see Health)
    T.Field("epoch", T.UINT64, tag=4),
])

ScoreResponse = T.Message("ScoreResponse", [
    T.Field("scores", T.Array(T.FLOAT32), tag=1),
])

# Page-encoded inference: the payload is a core/pages.py page whose records
# are fixed-layout structs, so the interesting bytes cross the wire exactly
# once and are decoded on the device.
InferRequest = T.Message("InferRequest", [
    T.Field("page", T.Array(T.BYTE), tag=1),       # PromptRecord{seq} page
    T.Field("max_new_tokens", T.UINT32, tag=2),
    T.Field("stop_token", T.INT32, tag=3),
    # SLO-aware scheduling (absent -> ServeConfig defaults): priority
    # class (higher preempts strictly lower under pool pressure) and
    # per-request latency targets in milliseconds (0 = no target)
    T.Field("priority", T.INT32, tag=4),
    T.Field("ttft_slo_ms", T.FLOAT32, tag=5),
    T.Field("tpot_slo_ms", T.FLOAT32, tag=6),
    # sampling tier, mirroring GenerateRequest (absent -> ServeConfig
    # defaults) — semantics in serving/sampling.py:GenerationParams
    T.Field("temperature", T.FLOAT32, tag=7),
    T.Field("top_k", T.UINT32, tag=8),
    T.Field("top_p", T.FLOAT32, tag=9),
    T.Field("seed", T.UINT32, tag=10),
    T.Field("n", T.UINT32, tag=11),
])

InferResponse = T.Message("InferResponse", [
    T.Field("page", T.Array(T.BYTE), tag=1),       # GenRecord{new} page
    T.Field("batch", T.UINT32, tag=2),
    T.Field("new_tokens", T.UINT32, tag=3),
])

InferChunk = T.Message("InferChunk", [
    T.Field("index", T.UINT32, tag=1),
    T.Field("page", T.Array(T.BYTE), tag=2),       # GenRecord1 page
    T.Field("epoch", T.UINT64, tag=3),             # producing process epoch
])

# Scheduler/engine observability: every counter the batcher pre-initializes
# (so the key set is stable from the first call) as parallel name/value
# columns — dashboards poll this instead of scraping logs.
StatsRequest = T.Message("StatsRequest", [
    T.Field("scope", T.STRING, tag=1),             # reserved; "" = all
])

StatsResponse = T.Message("StatsResponse", [
    T.Field("names", T.STRING, tag=1),             # newline-joined keys
    T.Field("values", T.Array(T.FLOAT64), tag=2),  # aligned with names
])

# Liveness/readiness probe: answered even while the server drains (load
# balancers must see "draining" to stop routing, not a refused call).
HealthRequest = T.Message("HealthRequest", [
    T.Field("verbose", T.BOOL, tag=1),             # include engine gauges
])

HealthResponse = T.Message("HealthResponse", [
    T.Field("serving", T.BOOL, tag=1),             # accepting new work
    T.Field("draining", T.BOOL, tag=2),            # finishing in-flight only
    T.Field("inflight", T.UINT32, tag=3),          # handler tasks running
    T.Field("names", T.STRING, tag=4),             # engine gauges (verbose)
    T.Field("values", T.Array(T.FLOAT64), tag=5),  # aligned with names
    # per-process start token (monotonic across restarts of a backend):
    # a changed epoch means stream cursors and dedup state from the old
    # process are void — routers must not resume against it silently
    T.Field("epoch", T.UINT64, tag=6),
])

InferenceService = ServiceDef("Inference", [
    MethodDef("Tokenize", TokenizeRequest, TokenBatch),
    MethodDef("Generate", GenerateRequest, GenerateResponse),
    MethodDef("Stream", GenerateRequest, TokenChunk, server_stream=True),
    MethodDef("Score", TokenBatch, ScoreResponse),
    MethodDef("Infer", InferRequest, InferResponse),
    MethodDef("InferStream", InferRequest, InferChunk, server_stream=True),
    MethodDef("ScorePage", InferResponse, ScoreResponse),
    MethodDef("Stats", StatsRequest, StatsResponse),
    MethodDef("Health", HealthRequest, HealthResponse),
])

#: method ids a draining server still answers: probes must keep working
#: while in-flight inference finishes, or the balancer flaps the backend
DRAIN_EXEMPT_METHODS = frozenset(
    m.id for m in InferenceService.methods if m.name in ("Health", "Stats"))


# -- page record schemas -------------------------------------------------------


def prompt_record_struct(seq_len: int) -> T.Struct:
    """One inference prompt row: ``struct PromptRecord{N} { tokens: u32[N] }``."""
    return T.Struct(f"PromptRecord{seq_len}", [
        T.Field("tokens", T.FixedArray(T.UINT32, seq_len)),
    ])


def gen_record_struct(new_tokens: int) -> T.Struct:
    """One generated row: ``struct GenRecord{N} { tokens: u32[N] }``."""
    return T.Struct(f"GenRecord{new_tokens}", [
        T.Field("tokens", T.FixedArray(T.UINT32, new_tokens)),
    ])


def encode_prompt_page(tokens: np.ndarray) -> bytes:
    """[B, T] tokens -> one PromptRecord page (the client-side encoder)."""
    tokens = np.atleast_2d(np.asarray(tokens))
    s = prompt_record_struct(tokens.shape[1])
    recs = np.zeros(tokens.shape[0], dtype=fastwire.static_dtype(s))
    recs["tokens"] = tokens.astype("<u4")
    return pages.write_page(s.name, recs)


def encode_gen_page(tokens: np.ndarray) -> bytes:
    """[B, N] generated tokens -> one GenRecord page."""
    tokens = np.atleast_2d(np.asarray(tokens))
    s = gen_record_struct(tokens.shape[1])
    recs = np.zeros(tokens.shape[0], dtype=fastwire.static_dtype(s))
    recs["tokens"] = tokens.astype("<u4")
    return pages.write_page(s.name, recs)


def decode_token_page(buf) -> np.ndarray:
    """Page of {Prompt,Gen}Record -> [B, N] uint32 (host view); an empty
    buffer is the zero-generated-tokens response: [0, 0]."""
    if len(buf) == 0:
        return np.zeros((0, 0), dtype="<u4")
    payload = pages.read_payload(buf)
    return np.ascontiguousarray(payload).view("<u4").reshape(
        payload.shape[0], payload.shape[1] // 4)


def _tokens_2d(msg: dict) -> np.ndarray:
    toks = np.asarray(msg["tokens"], dtype=np.int32)
    b = int(msg.get("batch", 1))
    s = int(msg.get("seq_len", len(toks) // max(b, 1)))
    return toks.reshape(b, s)


class InferenceImpl:
    """Service implementation over an Engine.

    The page path owns a :class:`PageIngest` on the engine's device (which
    defaults to the card) and a batcher: the :class:`PagedBatcher` when the
    serve config asks for paging and the model family supports it, else
    the dense :class:`ContinuousBatcher`, as in JAX.
    """

    # Distinct prompt widths one service plans decodes for: the width is
    # client-controlled, so without a bound a client sweeping strides
    # would grow the plan cache without limit.
    MAX_PLAN_WIDTHS = 64

    def __init__(self, engine: Engine, *,
                 ingest: Optional[PageIngest] = None,
                 batcher=None):
        self.engine = engine
        self.ingest = ingest or PageIngest(device=engine.device)
        if batcher is None:
            # mixed-length paged scheduling when the model family supports
            # it (serve config can force the dense path with paged=False)
            batcher = PagedBatcher(engine) \
                if engine.serve.paged and engine.supports_paged \
                else ContinuousBatcher(engine)
        self.batcher = batcher
        # per-process start token: stamped in Health and in every stream
        # chunk so a router/client can tell a restarted backend (whose
        # cursors and dedup state are gone) from a reconnect to the same
        # process.  time_ns is monotonic across restarts on one host.
        self.epoch = time.time_ns()
        self._plan_lock = threading.Lock()
        self._known_seqs: Dict[int, bool] = {}
        self._server: Optional[Server] = None

    def attach_server(self, server: Server) -> None:
        """Wire the impl to its server: Health reports drain state, and
        probe methods stay answerable while the server drains."""
        self._server = server
        server.drain_exempt |= DRAIN_EXEMPT_METHODS

    # -- page plumbing -------------------------------------------------------
    def _ensure_plan(self, seq_len: int) -> None:
        """Register Prompt/Gen record plans for this width exactly once."""
        with self._plan_lock:
            if seq_len in self._known_seqs:
                return
            if len(self._known_seqs) >= self.MAX_PLAN_WIDTHS:
                raise RpcError(Status.RESOURCE_EXHAUSTED,
                               "too many distinct prompt widths")
            self.ingest.register(prompt_record_struct(seq_len))
            self.ingest.register(gen_record_struct(seq_len))
            self._known_seqs[seq_len] = True

    def _admit_tokens(self, req: dict, ctx: RpcContext) -> np.ndarray:
        """InferRequest page -> [B, T] int32 via the device decode path."""
        ctx.check_deadline()  # shed before any placement work
        raw = req.get("page")
        if raw is None or len(raw) == 0:
            raise RpcError(Status.INVALID_ARGUMENT, "missing page payload")
        # pages.* speak the buffer protocol; no copy of the payload here
        buf = raw if isinstance(raw, (bytes, bytearray, memoryview)) \
            else np.ascontiguousarray(raw)
        try:
            header = pages.read_header(buf)
            if header.record_stride % 4 or header.record_stride == 0:
                raise pages.PageError(
                    f"prompt stride {header.record_stride} is not a "
                    f"positive multiple of 4 (u32 tokens)")
            if header.record_count == 0:
                raise pages.PageError("page holds zero records")
            seq_len = header.record_stride // 4
            if seq_len > self.engine.serve.cache_len:
                raise pages.PageError(
                    f"prompt length {seq_len} exceeds engine cache "
                    f"{self.engine.serve.cache_len}")
            self._ensure_plan(seq_len)
            admitted = self.ingest.admit(buf, deadline=ctx.deadline)
        except pages.PageError as e:
            # Admission signals mid-ingest expiry as a PageError; surface it
            # as the deadline status, not as a malformed request.
            code = Status.DEADLINE_EXCEEDED if "deadline" in str(e) \
                else Status.INVALID_ARGUMENT
            raise RpcError(code, f"bad page: {e}") from e
        # the scheduler plans on the host (prefix hashes, drafts), as the
        # JAX handler's np.asarray does
        t0 = spans.now() if spans.on else 0
        tokens = admitted.columns["tokens"].cpu().numpy()
        if t0:
            spans.add("ingest.to_host", t0)
        return tokens

    def _await(self, fut: _cf.Future, ctx: RpcContext) -> np.ndarray:
        timeout = None
        if ctx.deadline is not None:
            timeout = max(ctx.deadline.remaining(), 0.0) + 1.0
        try:
            return fut.result(timeout=timeout)
        except ShedError as e:
            code = Status.DEADLINE_EXCEEDED if "deadline" in str(e) \
                else Status.RESOURCE_EXHAUSTED
            raise RpcError(code, str(e)) from e
        except _cf.TimeoutError:
            raise RpcError(Status.DEADLINE_EXCEEDED,
                           "deadline expired waiting for batch slot") from None

    # -- page-encoded inference (the device-resident path) --------------------
    def Infer(self, req: dict, ctx: RpcContext) -> dict:
        ctx.check_deadline()
        tokens = self._admit_tokens(req, ctx)
        # one validator for every handler: absent-vs-explicit semantics
        # live in GenerationParams' docstring, not per-handler `in` checks
        gp = self._params(req, tokens)
        fut = self.batcher.submit(tokens, params=gp, deadline=ctx.deadline)
        # If the caller's connection dies mid-call, cancel so the request's
        # KV blocks return to the pool instead of decoding for nobody —
        # UNLESS the call is idempotency-keyed: a keyed caller is coming
        # back for this exact result (the dedup cache replays it), so it
        # must run to completion for exactly-once semantics.
        hook = None
        cancel = getattr(self.batcher, "cancel", None)
        if ctx.conn is not None and cancel is not None \
                and IDEMPOTENCY_KEY not in ctx.metadata:
            hook = ctx.conn.on_close(lambda: cancel(fut))
        try:
            out = self._await(fut, ctx)
        finally:
            if hook is not None:
                ctx.conn.discard(hook)
        # zero generated tokens (deadline hit right after prefill) is a
        # success with an empty page, not an absent field — clients decode
        # unconditionally
        return {"batch": out.shape[0], "new_tokens": out.shape[1],
                "page": encode_gen_page(out) if out.shape[1] else b""}

    def infer(self, page: bytes, *, max_new_tokens: Optional[int] = None,
              deadline=None, **fields) -> dict:
        """The ``Infer`` handler called in process: ``max_new_tokens``
        absent means the handler default (16); ``fields`` are any other
        ``InferRequest`` fields (``temperature``, ``seed``, ``n``, ...);
        ``deadline`` is any object with ``expired()`` and ``remaining()``.
        Returns the ``InferResponse`` dict."""
        req = dict(fields, page=page)
        if max_new_tokens is not None:
            req["max_new_tokens"] = max_new_tokens
        return self.Infer(req, RpcContext(deadline=deadline))

    def score_page(self, page: bytes, *, deadline=None) -> dict:
        """The ``ScorePage`` handler called in process: mean log-prob of
        every token row of ``page``, ``{"scores": float32 [B]}``."""
        return self.ScorePage({"page": page}, RpcContext(deadline=deadline))

    def close(self) -> None:
        self.batcher.close()

    def _params(self, req: dict, tokens: np.ndarray) -> GenerationParams:
        """Validate the request's generation fields against its prompt."""
        gp = GenerationParams.from_request(req)
        if gp.n > 1 and tokens.shape[0] != 1:
            raise RpcError(Status.INVALID_ARGUMENT,
                           f"n={gp.n} parallel sampling needs a single-row "
                           f"prompt, got batch {tokens.shape[0]}")
        return gp

    def _token_stream(self, tokens: np.ndarray, maxn: int,
                      stop_token: Optional[int], ctx: RpcContext, *,
                      sampling: Optional[SamplingParams] = None) -> Iterator:
        """Yield (index, [B,1] tokens) AS the decode loop produces them.

        Generation runs on a worker thread feeding a queue, so each frame
        flushes the moment its decode step finishes — time-to-first-token
        is one prefill + one decode step, not the whole generation.
        Sampled streams stay cursor-resumable: the folded-key schedule
        makes each draw a pure function of (seed, output index, row), so
        the resume path's regeneration replays them exactly.
        """
        q: _queue.Queue = _queue.Queue()
        cancelled = threading.Event()

        class _Cancelled(Exception):
            pass

        def on_token(i, tok):
            if cancelled.is_set():  # client went away: stop decoding
                raise _Cancelled()
            q.put((i, tok))

        def worker():
            try:
                self.engine.generate(tokens, max_new_tokens=maxn,
                                     stop_token=stop_token,
                                     deadline=ctx.deadline,
                                     start_from=int(ctx.cursor),
                                     on_token=on_token,
                                     sampling=sampling)
            except _Cancelled:
                pass
            except BaseException as e:  # noqa: BLE001 - relayed to the caller
                q.put(e)
            finally:
                q.put(None)  # always wake the consumer, even if cancelled

        threading.Thread(target=worker, daemon=True,
                         name="serve-stream-gen").start()
        # A consumer that vanishes mid-stream normally surfaces as a failed
        # send; the conn hook additionally catches the case where the
        # connection dies while the decode loop is busy between frames —
        # it both aborts the decode loop and wakes the consumer (which
        # would otherwise block forever on a queue no one feeds again).
        def on_conn_close():
            cancelled.set()
            q.put(None)

        hook = None
        if ctx.conn is not None:
            hook = ctx.conn.on_close(on_conn_close)
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancelled.set()  # dropped consumer aborts the decode loop
            if hook is not None:
                ctx.conn.discard(hook)

    def InferStream(self, req: dict, ctx: RpcContext) -> Iterator[dict]:
        """Page-encoded streaming with cursor resumption (§7.5).

        Streams bypass the batcher (each step must flush immediately); the
        cursor counts delivered decode steps, so a reconnect regenerates
        deterministically and skips what the client already holds.
        """
        tokens = self._admit_tokens(req, ctx)
        gp = self._params(req, tokens)
        if gp.n > 1:
            # streams bypass the batcher, so candidates replicate the
            # prompt across rows here; each chunk's page carries n records
            tokens = np.repeat(tokens, gp.n, axis=0)
        for i, tok in self._token_stream(
                tokens, gp.max_new_tokens, gp.stop_token, ctx,
                sampling=gp.sampling(self.engine.serve)):
            ctx.set_cursor(i + 1)
            yield {"index": i, "page": encode_gen_page(tok),
                   "epoch": self.epoch}

    def ScorePage(self, req: dict, ctx: RpcContext) -> dict:
        """Score a token page (chains after Infer via batch pipelining)."""
        ctx.check_deadline()
        tokens = self._admit_tokens(req, ctx).astype(np.int32)
        if tokens.shape[1] < 2:
            raise RpcError(Status.INVALID_ARGUMENT,
                           "scoring needs at least 2 tokens per row")
        return {"scores": self.engine.score(tokens).astype(np.float32)}

    # tokenizer stub: bytes -> ids mod vocab (a real deployment plugs a
    # sentencepiece model here; the RPC layer is what we exercise)
    def Tokenize(self, req: dict, ctx: RpcContext) -> dict:
        data = req.get("text", "").encode("utf-8")
        seq = int(req.get("seq_len", 32))
        ids = np.frombuffer(data, dtype=np.uint8).astype(np.uint32)
        ids = np.resize(ids, seq) % self.engine.cfg.vocab_size
        return {"tokens": ids, "batch": 1, "seq_len": seq}

    def Generate(self, req: dict, ctx: RpcContext) -> dict:
        if ctx.deadline is not None and ctx.deadline.expired():
            raise RpcError(Status.DEADLINE_EXCEEDED,
                           "deadline expired before prefill")
        tokens = _tokens_2d(req)
        # (an explicit max_new_tokens=0 used to fall back to the engine
        # default through `int(...) or None`; GenerationParams keeps it a
        # prefill-only request, same as every other handler)
        gp = self._params(req, tokens)
        if gp.n > 1:
            tokens = np.repeat(tokens, gp.n, axis=0)
        out = self.engine.generate(
            tokens, max_new_tokens=gp.max_new_tokens,
            stop_token=gp.stop_token, deadline=ctx.deadline,
            sampling=gp.sampling(self.engine.serve))
        return {"tokens": out.reshape(-1).astype(np.uint32),
                "batch": out.shape[0], "new_tokens": out.shape[1]}

    def Stream(self, req: dict, ctx: RpcContext) -> Iterator[dict]:
        """Token streaming with frame-level cursor resumption (§7.5).

        cursor = number of tokens the client fully processed; on reconnect
        the handler skips past them (generation is deterministic: greedy,
        or seeded sampling replayed through the folded-key schedule).
        """
        tokens = _tokens_2d(req)
        gp = self._params(req, tokens)
        if gp.n > 1:
            tokens = np.repeat(tokens, gp.n, axis=0)
        for i, tok in self._token_stream(
                tokens, gp.max_new_tokens, None, ctx,
                sampling=gp.sampling(self.engine.serve)):
            ctx.set_cursor(i + 1)  # next frame carries the position marker
            yield {"index": i, "tokens": tok.reshape(-1).astype(np.uint32),
                   "epoch": self.epoch}

    def Score(self, req: dict, ctx: RpcContext) -> dict:
        tokens = _tokens_2d(req)
        return {"scores": self.engine.score(tokens).astype(np.float32)}

    def Stats(self, req: dict, ctx: RpcContext) -> dict:
        """Scheduler/engine/ingest counters as aligned name/value columns.

        The batcher pre-initializes every counter it will ever report, so
        the key set is stable from the very first call — a dashboard can
        lay out its panels against one response and never see keys appear
        later.
        """
        stats: Dict[str, float] = dict(
            self.batcher.collect_stats()
            if hasattr(self.batcher, "collect_stats")
            else self.batcher.stats)
        stats.update({f"engine_{k}": v for k, v in self.engine.stats.items()})
        stats.update({f"ingest_{k}": v for k, v in self.ingest.stats.items()})
        if self._server is not None:
            # RPC-layer resilience counters, surfaced end to end:
            # routers score replicas with them, operators debug with them
            stats["server_conn_errors"] = self._server.conn_errors
            stats["server_dedup_hits"] = self._server.dedup.hits
            stats["server_dedup_evictions"] = self._server.dedup.evictions
            stats["server_dedup_entries"] = len(self._server.dedup)
        names = sorted(stats)
        return {"names": "\n".join(names),
                "values": np.asarray([float(stats[n]) for n in names],
                                     np.float64)}

    def Health(self, req: dict, ctx: RpcContext) -> dict:
        """Serving/draining state plus (verbose) live engine gauges.

        Registered drain-exempt: a draining server answers this with
        ``serving=False, draining=True`` while refusing new inference, so
        a balancer drains traffic instead of flapping the backend.
        """
        draining = bool(self._server is not None and self._server.draining)
        inflight = self._server.inflight if self._server is not None else 0
        out: dict = {"serving": not draining, "draining": draining,
                     "inflight": inflight, "epoch": self.epoch}
        if req.get("verbose"):
            gauges: Dict[str, float] = dict(
                self.batcher.collect_stats()
                if hasattr(self.batcher, "collect_stats")
                else self.batcher.stats)
            names = sorted(gauges)
            out["names"] = "\n".join(names)
            out["values"] = np.asarray([float(gauges[n]) for n in names],
                                       np.float64)
        return out


def build_server(engine: Engine, *, descriptor: bytes = b"",
                 impl: Optional[InferenceImpl] = None) -> Server:
    impl = impl or InferenceImpl(engine)
    router = Router()
    router.add_service(InferenceService, impl)
    server = Server(router, descriptor=descriptor)
    impl.attach_server(server)
    return server
