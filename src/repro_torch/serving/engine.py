"""Serving engine + the schedulers, on PyTorch.

A port of the JAX package's ``serving/engine.py``: :class:`ServeConfig`
(field for field); :class:`Engine` (model, params, dense generation —
greedy or seeded sampling, resumable from a stream cursor — scoring and
the paged step functions); the dense :class:`ContinuousBatcher`, which
merges greedy requests of one prompt length into one prefill + decode run
and runs sampled ones alone; and :class:`PagedBatcher`, whose scheduling —
fused prefill/decode steps under the ``max_step_tokens`` budget, the
prefix cache with copy-on-write, n-gram speculative decode (exact-match
for greedy rows, rejection sampling for sampled ones), ``n > 1``
candidates forked over shared prompt blocks, swap preemption with the SLO
controller, shedding, the dense fallback for requests too large for the
pool, and stats — is the JAX batcher's, line for line.

Greedy rows of the dense engine take their argmax on the device; sampled
rows bring their logits to the host, where :mod:`.sampling` filters them
and walks the CDF, as the reference does.
"""
from __future__ import annotations

import collections
import concurrent.futures as _cf
import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.device import torch_device
from ..models import get_model
from .kv_cache import CacheOOM, PagedKVCache, block_keys
from .sampling import (GREEDY, GenerationParams, SamplingParams,
                       rejection_sample, sample_tokens, spec_uniforms,
                       target_probs)
from .spec import ngram_propose

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    cache_len: int = 1024
    max_new_tokens: int = 64
    # default sampling for requests that carry none: temperature 0 =
    # greedy argmax; top_k 0 / top_p 1.0 disable the filters; seed feeds
    # the per-request folded keys (serving/sampling.py)
    temperature: float = 0.0    # 0 = greedy
    top_k: int = 0              # 0 = no top-k filter
    top_p: float = 1.0          # 1.0 = no nucleus (top-p) filter
    seed: int = 0               # base PRNG seed for sampled requests
    # paged KV cache; paged=True routes supported model families through
    # PagedBatcher, others (and paged=False) use the dense ContinuousBatcher
    paged: bool = True
    block_size: int = 16        # tokens per KV block (64B-alignment rounds up)
    prefill_chunk: int = 32     # prompt tokens prefilled per chunked step
    num_blocks: int = 0         # 0 = auto: max_batch * blocks_per_seq + null
    # fused prefill/decode scheduling; False restores the blocking
    # chunked-prefill loop
    fused_prefill: bool = True
    # per-step budget of NEW tokens a fused step may process (decode rows
    # count 1 each; prefilling rows share the remainder, clamped to
    # prefill_chunk).  0 = no budget.
    max_step_tokens: int = 0
    # automatic prefix caching: matched blocks are shared (refcounted,
    # copy-on-write on conflict) and their prefill is skipped
    prefix_cache: bool = True
    # cap on cached-but-unreferenced prefix blocks kept resident (0 =
    # bounded only by the pool)
    prefix_lru_blocks: int = 0
    # self-speculative decoding: an n-gram drafter over each row's own
    # history proposes up to spec_len tokens and ONE verify step scores
    # them; emitted tokens stay bit-identical to plain greedy decode
    spec_decode: bool = True
    spec_len: int = 4           # max drafted tokens per request per step
    spec_ngram: int = 2         # shortest suffix n-gram worth drafting from
    # SLO-aware scheduling: swap=True pages lowest-priority victims' KV
    # blocks to host under pool pressure instead of shedding
    swap: bool = True
    default_priority: int = 0   # priority class when submit() passes none
    ttft_slo_ms: float = 0.0    # default time-to-first-token target (0=off)
    tpot_slo_ms: float = 0.0    # default inter-token latency target (0=off)
    # scheduler steps between SLO-controller updates of max_step_tokens
    slo_adjust_every: int = 16


class Engine:
    """One model on one device: parameters, dense generation (greedy or
    sampled) and scoring, and the paged step functions.

    ``device`` defaults to ``"cuda"`` and raises when there is no card;
    pass ``device="cpu"`` to run the plain PyTorch path.  ``params``, when
    given, must already live on ``device`` (see
    :func:`repro_torch.checkpoint.bridge.params_from_numpy`); otherwise
    they are drawn from a ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(self, cfg: ModelConfig, serve_cfg: ServeConfig,
                 params: Optional[Any] = None, *, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.serve = serve_cfg
        self.device = torch_device(device)
        self.model = get_model(cfg)
        if params is None:
            params = self.model.init(seed, self.device)
        self.params = params
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens_out": 0}

    @property
    def supports_paged(self) -> bool:
        return bool(getattr(self.model, "supports_paged", False))

    def paged_step_fn(self):
        """The paged step: logits at each row's last valid token."""
        return self.model.paged_step

    def paged_verify_fn(self):
        """The speculative verify step: logits at every position."""
        return self.model.paged_step_verify

    # -- generation --------------------------------------------------------------
    def generate(self, tokens: np.ndarray, *,
                 max_new_tokens: Optional[int] = None,
                 stop_token: Optional[int] = None,
                 deadline=None, start_from: int = 0, on_token=None,
                 sampling: Optional[SamplingParams] = None) -> np.ndarray:
        """Greedy or sampled generation from a [B, T] prompt: one dense
        prefill into a ``cache_len`` cache, then one decode step per token.
        Returns [B, new] int32.

        ``start_from``: number of already-delivered tokens to skip (the
        stream-cursor resume path: generation is deterministic, so the
        handler regenerates and skips what the client already has);
        ``on_token(index, tok)`` sees each delivered [B, 1] column as it is
        produced.  ``sampling`` (default greedy) picks each token with
        :func:`~repro_torch.serving.sampling.sample_tokens`; row ``r`` of
        the batch is candidate ``r`` of the key schedule, as in the paged
        engine's forks.
        """
        sc = self.serve
        sp = GREEDY if sampling is None else sampling
        maxn = sc.max_new_tokens if max_new_tokens is None else max_new_tokens
        tokens = np.atleast_2d(np.asarray(tokens, dtype=np.int32))
        b, t = tokens.shape
        logits, cache = self.model.prefill(self.params,
                                           self._prefill_batch(tokens),
                                           sc.cache_len)
        self.stats["prefills"] += 1
        out: List[np.ndarray] = []
        pos = t
        next_tok = self._pick(logits, sp, 0)
        for i in range(maxn):
            if deadline is not None and deadline.expired():
                break
            if i >= start_from:
                out.append(next_tok)
                if on_token is not None:
                    on_token(i, next_tok)
            logits, cache = self.model.decode_step(
                self.params, torch.from_numpy(next_tok).to(self.device),
                cache, pos)
            self.stats["decode_steps"] += 1
            pos += 1
            next_tok = self._pick(logits, sp, i + 1)
            if stop_token is not None and bool((next_tok == stop_token).all()):
                break
        self.stats["tokens_out"] += len(out) * b
        return np.concatenate(out, axis=1) if out else \
            np.zeros((b, 0), np.int32)

    @staticmethod
    def _pick(logits: torch.Tensor, sp: SamplingParams,
              index: int) -> np.ndarray:
        """Next token column [B, 1].  Greedy: the argmax on the device (the
        first of equal maxima, as ``jnp.argmax``), only [B] ids to the
        host.  Sampled: the logits come to the host for the seeded
        sampler."""
        if sp.greedy:
            return logits.argmax(-1).to(torch.int32).cpu().numpy()[:, None]
        return sample_tokens(_logits_to_host(logits), sp,
                             index=index)[:, None]

    def _prefill_batch(self, tokens: np.ndarray) -> Dict[str, torch.Tensor]:
        """The model's batch for a [B, T] prompt.  Frame inputs (the
        encoder-decoder) get the stub frontend's zero frames
        [B, max(T // frame_ratio, 1), D], as in JAX; embedding inputs
        (qwen2-vl) have no served path here or in JAX and raise."""
        cfg = self.cfg
        batch = {"tokens": torch.from_numpy(
            np.ascontiguousarray(tokens, dtype=np.int32)).to(self.device)}
        if cfg.input_kind == "frames":
            b, t = tokens.shape
            batch["frames"] = torch.zeros(
                (b, max(t // cfg.frame_ratio, 1), cfg.d_model),
                dtype=torch.float32, device=self.device)
        elif cfg.input_kind == "embeddings":
            raise NotImplementedError(
                "vlm serving requires precomputed embeddings; use "
                "generate_from_embeds")
        return batch

    # -- scoring (the ScorePage body: Infer -> ScorePage chains) --------------
    def score(self, tokens: np.ndarray) -> np.ndarray:
        """Mean log-prob of each sequence under the model.  [B, T] -> [B]
        float32: ``log_softmax`` in float32 over the logits of
        ``tokens[:, :-1]``, gathered at ``tokens[:, 1:]``, averaged over
        T - 1 on the device; only the [B] means come back."""
        tokens = np.atleast_2d(np.asarray(tokens, dtype=np.int32))
        batch = self._prefill_batch(tokens)   # frames for T, as in JAX
        toks = batch["tokens"]
        logits = self.model.logits(self.params,
                                   {**batch, "tokens": toks[:, :-1]})
        lf = torch.log_softmax(logits.float(), dim=-1)
        del logits
        picked = torch.gather(lf, -1, toks[:, 1:].long()[..., None])[..., 0]
        return picked.mean(-1).cpu().numpy()


class ShedError(RuntimeError):
    """Request dropped by the scheduler (queue overflow or expired deadline)."""


def _config_sampling(sc: ServeConfig) -> SamplingParams:
    """The ServeConfig-default sampling for requests that pass none."""
    return SamplingParams(temperature=sc.temperature, top_k=sc.top_k,
                          top_p=sc.top_p, seed=sc.seed)


def _logits_to_host(out: torch.Tensor) -> np.ndarray:
    """Device logits -> host float32 array.  bf16 logits travel as their
    raw 16-bit patterns (half the bytes of a float32 copy) and widen on
    the host, exactly: ``argmax`` sees the same values either way."""
    if out.dtype == torch.bfloat16:
        bits = out.contiguous().view(torch.int16).cpu().numpy()
        return (bits.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return out.float().cpu().numpy()


@dataclasses.dataclass(eq=False)   # identity semantics: queues/slot lists
class _Pending:                    # look these up with `in` / `.remove()`
    """One admitted request group: [B, T] prompt rows awaiting assembly."""

    tokens: np.ndarray
    max_new_tokens: int
    stop_token: Optional[int]
    deadline: Optional[Any]
    future: _cf.Future
    sampling: SamplingParams = GREEDY
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)
    cancelled: bool = False     # caller gone (connection died): stop paying

    @property
    def rows(self) -> int:
        return self.tokens.shape[0]

    @property
    def seq_len(self) -> int:
        return self.tokens.shape[1]

    def expired(self) -> bool:
        return self.cancelled or (
            self.deadline is not None and self.deadline.expired())


class ContinuousBatcher:
    """Admission queue + batch assembly in front of a single Engine (the
    dense-cache scheduler).

    Requests are submitted from handler threads and resolved by one worker
    thread.  Assembly greedily merges queued requests that share a prompt
    length and stop token up to ``max_batch`` rows, waiting at most
    ``window_s`` for stragglers once the first request is in hand, and
    runs the group as ONE :meth:`Engine.generate`; sampled requests run
    alone, so their tokens do not depend on batch composition.  Deadlines shed work on
    submit (full queue or already expired) and again at assembly.  It
    serves model families without paged-KV support (the hybrid model) and
    ``ServeConfig(paged=False)``.
    """

    def __init__(self, engine: Engine, *, max_batch: Optional[int] = None,
                 max_queue: int = 64, window_s: float = 0.005):
        self.engine = engine
        self.max_batch = max_batch or engine.serve.max_batch
        self.max_queue = max_queue
        self.window_s = window_s
        self._queue: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._closed = False  # guarded by _cond
        self.stats = {"requests": 0, "rows": 0, "batches": 0,
                      "batched_rows": 0, "shed": 0, "worker_errors": 0,
                      "cancelled": 0, "sampled_requests": 0}
        self._worker_error_logged = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="serve-batcher")
        self._worker.start()

    # -- admission ----------------------------------------------------------
    def submit(self, tokens: np.ndarray, *,
               params: Optional[GenerationParams] = None,
               max_new_tokens: Optional[int] = None,
               stop_token: Optional[int] = None,
               deadline=None, sampling: Optional[SamplingParams] = None,
               n: int = 1) -> _cf.Future:
        """Queue a [B, T] (or [T]) prompt; resolves to [B, new] int32.

        ``params`` supplies every per-request field at once; the dense
        scheduler has no preemption tier, so its priority and SLO fields
        are ignored.  ``sampling`` (default: the ServeConfig sampling
        fields) draws each token with the seeded sampler; sampled requests
        are never merged with others.  ``n > 1`` (single-row prompt only)
        replicates the prompt across the batch axis: the dense cache pays
        the prompt's KV n times, and a ``stop_token`` ends the group only
        when every candidate has emitted it.
        """
        if params is not None:
            params.validate()
            max_new_tokens = params.max_new_tokens
            stop_token = params.stop_token
            sampling = params.sampling(self.engine.serve)
            n = params.n
        tokens = np.atleast_2d(np.asarray(tokens, dtype=np.int32))
        sp = _config_sampling(self.engine.serve) if sampling is None \
            else sampling
        n = max(1, int(n))
        if n > 1:
            if tokens.shape[0] != 1:
                raise ValueError(
                    f"n={n} parallel sampling needs a single-row prompt, "
                    f"got batch {tokens.shape[0]}")
            tokens = np.repeat(tokens, n, axis=0)
        maxn = self.engine.serve.max_new_tokens if max_new_tokens is None \
            else max_new_tokens  # explicit 0 = prefill-only, not the default
        p = _Pending(tokens, maxn, stop_token, deadline, _cf.Future(),
                     sampling=sp)
        with self._cond:
            if self._closed:
                self.stats["shed"] += 1
                p.future.set_exception(ShedError("batcher closed"))
                return p.future
            if p.expired():
                self.stats["shed"] += 1
                p.future.set_exception(
                    ShedError("deadline expired before admission"))
                return p.future
            if len(self._queue) >= self.max_queue:
                self.stats["shed"] += 1
                p.future.set_exception(ShedError("admission queue full"))
                return p.future
            self._queue.append(p)
            self.stats["requests"] += 1
            self.stats["rows"] += p.rows
            if not sp.greedy:
                self.stats["sampled_requests"] += 1
            self._cond.notify()
        return p.future

    def generate(self, tokens: np.ndarray, **kw) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(tokens, **kw).result()

    def cancel(self, fut: _cf.Future) -> bool:
        """Drop the queued request owning ``fut``; a group already running
        completes (its result is discarded).  Returns True if found."""
        with self._cond:
            for p in self._queue:
                if p.future is fut:
                    p.cancelled = True
                    self.stats["cancelled"] += 1
                    self._cond.notify_all()
                    return True
        return False

    # -- assembly -----------------------------------------------------------
    def _take_group(self) -> Optional[_Pending]:
        """Pop the first live request, shedding expired ones in place;
        None once the batcher is closed and drained."""
        with self._cond:
            while True:
                while self._queue:
                    p = self._queue.popleft()
                    if p.expired():
                        self.stats["shed"] += 1
                        p.future.set_exception(
                            ShedError("deadline expired in queue"))
                        continue
                    return p
                if self._closed:
                    return None
                self._cond.wait()

    def _take_compatible(self, head: _Pending) -> List[_Pending]:
        """Merge queued requests matching ``head`` up to max_batch rows."""
        group = [head]
        rows = head.rows
        cutoff = time.monotonic() + self.window_s
        while rows < self.max_batch:
            with self._cond:
                found = None
                shed = False
                for p in self._queue:
                    if p.expired():
                        self._queue.remove(p)
                        self.stats["shed"] += 1
                        p.future.set_exception(
                            ShedError("deadline expired in queue"))
                        shed = True
                        break  # deque mutated mid-iteration; rescan
                    if p.seq_len == head.seq_len \
                            and p.stop_token == head.stop_token \
                            and head.sampling.greedy and p.sampling.greedy \
                            and rows + p.rows <= self.max_batch:
                        # sampled requests run solo: merging would shift
                        # their row indices (their candidates) in the batch
                        found = p
                        break
                if found is not None:
                    self._queue.remove(found)
                    group.append(found)
                    rows += found.rows
                    continue
                if shed:
                    continue  # don't burn the window waiting; rescan now
                remaining = cutoff - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
        return group

    def _run(self) -> None:
        while True:
            head = self._take_group()
            if head is None:
                return
            group = self._take_compatible(head)
            try:
                self._execute(group)
            except Exception:  # noqa: BLE001 - the worker must survive
                # _execute fails futures itself; anything escaping here is
                # counted and the first logged
                self.stats["worker_errors"] += 1
                if not self._worker_error_logged:
                    self._worker_error_logged = True
                    _log.exception(
                        "ContinuousBatcher worker step raised; continuing "
                        "(further escapes counted in stats['worker_errors'])")
                continue

    def _execute(self, group: List[_Pending]) -> None:
        tokens = np.concatenate([p.tokens for p in group], axis=0) \
            if len(group) > 1 else group[0].tokens
        maxn = max(p.max_new_tokens for p in group)
        # run to the LATEST finite member deadline (the one with the most
        # time remaining): every member gets whatever prefix was generated
        # by then
        with_deadline = [p.deadline for p in group if p.deadline is not None]
        deadline = max(with_deadline, key=lambda d: d.remaining()) \
            if with_deadline else None
        try:
            out = self.engine.generate(tokens, max_new_tokens=maxn,
                                       stop_token=group[0].stop_token,
                                       deadline=deadline,
                                       sampling=group[0].sampling)
        except Exception as e:  # noqa: BLE001 - fail every member, keep serving
            for p in group:
                if not p.future.done():
                    p.future.set_exception(e)
            return
        self.stats["batches"] += 1
        self.stats["batched_rows"] += tokens.shape[0]
        row = 0
        for p in group:
            res = out[row:row + p.rows, :min(p.max_new_tokens, out.shape[1])]
            row += p.rows
            if p.stop_token is not None:
                # re-apply the request's own stop rule: merged batches run
                # longer than the request would alone
                hits = (res == p.stop_token).all(axis=0)
                if hits.any():
                    res = res[:, :int(np.argmax(hits))]
            if not p.future.done():  # racing cancel() must not kill us
                p.future.set_result(np.ascontiguousarray(res))

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=5.0)
        with self._cond:
            while self._queue:
                p = self._queue.popleft()
                p.future.set_exception(ShedError("batcher closed"))

    def mean_batch_rows(self) -> float:
        b = self.stats["batches"]
        return self.stats["batched_rows"] / b if b else 0.0

    def collect_stats(self) -> Dict[str, float]:
        """Complete snapshot: every counter plus live queue depth."""
        out: Dict[str, float] = dict(self.stats)
        out["queued_requests"] = len(self._queue)
        return out


@dataclasses.dataclass(eq=False)   # identity semantics: field-wise eq would
class _PagedReq:                   # compare [B, T] arrays of mixed shapes
    """One in-flight request: rows share a prompt and advance in lockstep."""

    tokens: np.ndarray                  # [B, T] prompt
    max_new_tokens: int
    stop_token: Optional[int]
    deadline: Optional[Any]
    future: _cf.Future
    rid: int
    on_token: Optional[Callable[[int, np.ndarray], None]] = None
    sampling: SamplingParams = GREEDY
    # n>1 parallel sampling: the request prefills as ONE row and _fork()
    # expands it to fork_n candidate rows sharing the prompt's blocks when
    # the first generated token is sampled
    fork_n: int = 1
    forked: bool = False
    # per-candidate stop mask of a forked request (None otherwise): a
    # candidate that samples stop_token freezes to stop-token padding
    # while its siblings keep generating
    done: Optional[np.ndarray] = None
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)
    # SLO-aware scheduling: priority class (higher preempts strictly
    # lower) and per-request latency targets in seconds (0 = no target)
    priority: int = 0
    ttft_slo_s: float = 0.0
    tpot_slo_s: float = 0.0
    first_emit_at: Optional[float] = None   # observed TTFT/TPOT inputs
    last_emit_at: Optional[float] = None
    cancelled: bool = False     # caller gone (connection died): stop paying
    # runtime state (set at admission)
    tables: Optional[np.ndarray] = None     # [B, M] int32 block tables
    slots: List[int] = dataclasses.field(default_factory=list)
    next_tok: Optional[np.ndarray] = None   # [B] pending (unemitted) tokens
    out: List[np.ndarray] = dataclasses.field(default_factory=list)
    pos_next: int = 0                       # absolute position of next write
    # [B, T + max_new + 1] committed-token history for the drafter
    hist: Optional[np.ndarray] = None

    @property
    def rows(self) -> int:
        return self.tokens.shape[0]

    @property
    def slots_needed(self) -> int:
        """Batch slots the request occupies at its widest: a pending fork
        prefills as one row but reserves ``fork_n`` slots up front so the
        expansion never deadlocks on a full batch."""
        return max(self.rows, self.fork_n)

    @property
    def seq_len(self) -> int:
        return self.tokens.shape[1]

    @property
    def prefilling(self) -> bool:
        """Prompt tokens remain to be written into the paged cache."""
        return self.pos_next < self.seq_len

    def expired(self) -> bool:
        return self.cancelled or (
            self.deadline is not None and self.deadline.expired())

    def emit(self, tok: np.ndarray) -> None:
        now = time.monotonic()
        if self.first_emit_at is None:
            self.first_emit_at = now
        self.last_emit_at = now
        self.out.append(tok)
        if self.hist is not None:
            self.hist[:, self.seq_len + len(self.out) - 1] = tok
        if self.on_token is not None:
            try:
                self.on_token(len(self.out) - 1, tok)
            except Exception:  # noqa: BLE001 - a hook must never be able
                # to desync scheduler state
                _log.exception("on_token callback raised; ignoring")


class PagedBatcher:
    """Mixed-length continuous batching over the paged KV cache.

    Every admitted request owns fixed-stride blocks in one shared pool,
    so one :meth:`~repro_torch.models.transformer.DecoderLM.paged_step`
    advances all active rows whatever their lengths, and new requests slot
    in between steps.  Admission only installs a prefill-in-progress row;
    the scheduler runs *fused* steps that advance every decode row by 1
    token AND every prefilling row by up to ``prefill_chunk`` prompt
    tokens (per-row ``last_idx``), budgeted by ``max_step_tokens``.  With
    the prefix cache on, prompts share already-resident full blocks and a
    write into a shared block copy-on-writes first.  When every active row
    decodes, an n-gram drafter proposes continuations and one verify step
    of width ``spec_len + 1`` scores them.  Under pool pressure (``swap``
    on) lower-priority requests are paged out to host and resume
    token-identically later; per-request TTFT/TPOT targets steer the live
    ``max_step_tokens``.  A sampled request draws each token through the
    seeded sampler, and its verify steps accept drafts by rejection
    sampling; ``submit(n=...)`` forks a prefilled prompt into n candidate
    rows that share its KV blocks and diverge by copy-on-write.  Every
    stats key is pre-initialized.

    Scheduling invariants (the JAX batcher's): the emitted tokens depend
    only on the prompt and the model; priority preempts strictly lower;
    every future resolves; no retirement path leaks a block.
    """

    def __init__(self, engine: Engine, *, max_batch: Optional[int] = None,
                 max_queue: int = 64):
        if not engine.supports_paged:
            raise ValueError(
                f"{engine.cfg.name}: model family has no paged-KV support")
        self.engine = engine
        cfg, sc = engine.cfg, engine.serve
        self.max_batch = max_batch or sc.max_batch
        self.max_queue = max_queue
        self.prefill_chunk = max(1, sc.prefill_chunk)
        self.fused = bool(sc.fused_prefill)
        self.max_step_tokens = max(0, int(sc.max_step_tokens))
        self.prefix_enabled = bool(sc.prefix_cache)
        self.spec_len = max(0, int(sc.spec_len))
        self.spec = bool(sc.spec_decode) and self.spec_len > 0
        self.spec_ngram = max(1, int(sc.spec_ngram))
        self.swap = bool(sc.swap)
        self.default_priority = int(sc.default_priority)
        self.ttft_slo_s = max(0.0, float(sc.ttft_slo_ms)) / 1e3
        self.tpot_slo_s = max(0.0, float(sc.tpot_slo_ms)) / 1e3
        self.slo_adjust_every = max(1, int(sc.slo_adjust_every))
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, cache_len=sc.cache_len,
            block_size=sc.block_size, num_blocks=sc.num_blocks,
            max_concurrent=self.max_batch, dtype=cfg.dtype,
            prefix_cache=self.prefix_enabled,
            prefix_lru_blocks=sc.prefix_lru_blocks)
        self.cache.pool = engine.model.init_paged_pool(
            self.cache.layout.num_blocks, self.cache.block_size,
            engine.device)
        self._step_fn = engine.paged_step_fn()
        self._verify_fn = engine.paged_verify_fn() if self.spec else None
        self._queue: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._closed = False  # guarded by _cond
        self._active: List[_PagedReq] = []
        self._slots: List[Optional[Tuple[_PagedReq, int]]] = \
            [None] * self.max_batch
        self._next_rid = 0  # guarded by _cond
        self._preempted: List[_PagedReq] = []
        self._ttft_obs: collections.deque = collections.deque(maxlen=128)
        self._tpot_obs: collections.deque = collections.deque(maxlen=128)
        self._steps_since_adjust = 0
        # ceiling for the SLO controller: one full chunk for every row
        self._step_budget_cap = max(self.max_batch * self.prefill_chunk,
                                    self.max_step_tokens)
        # the JAX batcher's full key set, so snapshots of the two packages
        # line up
        self.stats = {"requests": 0, "rows": 0, "shed": 0, "decode_steps": 0,
                      "batched_rows": 0, "prefill_chunks": 0,
                      "mixed_steps": 0, "admitted_in_flight": 0,
                      "dense_fallbacks": 0, "worker_errors": 0,
                      "prefix_hits": 0, "prefix_tokens_reused": 0,
                      "cow_copies": 0, "spec_steps": 0,
                      "spec_proposed": 0, "spec_accepted": 0,
                      "preemptions": 0, "swapped_blocks": 0, "swap_ins": 0,
                      "slo_violations": 0, "slo_adjustments": 0,
                      "cancelled": 0, "forks": 0, "spec_resamples": 0,
                      "sampled_requests": 0}
        self._worker_error_logged = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="serve-paged-batcher")
        self._worker.start()

    # -- admission ----------------------------------------------------------
    def submit(self, tokens: np.ndarray, *,
               max_new_tokens: Optional[int] = None,
               stop_token: Optional[int] = None,
               deadline=None, on_token=None,
               priority: Optional[int] = None,
               ttft_slo_ms: Optional[float] = None,
               tpot_slo_ms: Optional[float] = None,
               params: Optional[GenerationParams] = None,
               sampling: Optional[SamplingParams] = None,
               n: int = 1) -> _cf.Future:
        """Queue a [B, T] (or [T]) prompt; resolves to [B, new] int32.

        ``on_token(index, tok)`` is invoked from the worker thread as each
        token is emitted.  ``priority`` (higher wins) and the
        ``ttft_slo_ms``/``tpot_slo_ms`` targets drive the SLO-aware tier;
        ``params`` supplies every per-request field at once.  ``sampling``
        overrides the ServeConfig-default :class:`SamplingParams`.

        ``n > 1`` asks for parallel candidates of a single-row prompt: it
        is prefilled ONCE, then forked into ``n`` rows that share the
        prompt's KV blocks and diverge by copy-on-write from the first
        sampled token; the future resolves to [n, new] int32.  Each
        candidate stops on its own: a row that samples ``stop_token``
        freezes to stop-token padding while its siblings continue.
        """
        if params is not None:
            params.validate()
            max_new_tokens = params.max_new_tokens
            stop_token = params.stop_token
            priority = params.priority
            ttft_slo_ms = params.ttft_slo_ms
            tpot_slo_ms = params.tpot_slo_ms
            sampling = params.sampling(self.engine.serve)
            n = params.n
        tokens = np.atleast_2d(np.asarray(tokens, dtype=np.int32))
        sp = _config_sampling(self.engine.serve) if sampling is None \
            else sampling
        n = max(1, int(n))
        if n > 1 and tokens.shape[0] != 1:
            raise ValueError(
                f"n={n} parallel sampling needs a single-row prompt, "
                f"got batch {tokens.shape[0]}")
        maxn = self.engine.serve.max_new_tokens if max_new_tokens is None \
            else max_new_tokens  # explicit 0 = prefill-only
        pr = self.default_priority if priority is None else int(priority)
        ttft = self.ttft_slo_s if ttft_slo_ms is None \
            else max(0.0, float(ttft_slo_ms)) / 1e3
        tpot = self.tpot_slo_s if tpot_slo_ms is None \
            else max(0.0, float(tpot_slo_ms)) / 1e3
        with self._cond:
            self._next_rid += 1
            p = _PagedReq(tokens, maxn, stop_token, deadline, _cf.Future(),
                          self._next_rid, on_token, priority=pr,
                          ttft_slo_s=ttft, tpot_slo_s=tpot,
                          sampling=sp, fork_n=n)
            if p.seq_len == 0:
                # an installed 0-token request has no prefill to run and no
                # next_tok to feed: it would poison the SHARED step
                self.stats["shed"] += 1
                p.future.set_exception(ShedError("empty prompt"))
                return p.future
            if self._closed:
                self.stats["shed"] += 1
                p.future.set_exception(ShedError("batcher closed"))
                return p.future
            if p.expired():
                self.stats["shed"] += 1
                p.future.set_exception(
                    ShedError("deadline expired before admission"))
                return p.future
            if len(self._queue) >= self.max_queue:
                self.stats["shed"] += 1
                p.future.set_exception(ShedError("admission queue full"))
                return p.future
            self._queue.append(p)
            self.stats["requests"] += 1
            self.stats["rows"] += p.rows
            if not sp.greedy:
                self.stats["sampled_requests"] += 1
            self._cond.notify()
        return p.future

    def generate(self, tokens: np.ndarray, **kw) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(tokens, **kw).result()

    def cancel(self, fut: _cf.Future) -> bool:
        """Mark the request owning ``fut`` cancelled: the next sweep
        reclaims whatever it holds through the expired-deadline paths."""
        with self._cond:
            for p in (*self._queue, *self._active, *self._preempted):
                if p.future is fut:
                    p.cancelled = True
                    self.stats["cancelled"] += 1
                    self._cond.notify_all()
                    return True
        return False

    # -- worker -------------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._active \
                        and not self._preempted and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue and not self._active:
                    for req in list(self._preempted):
                        self._retire(req, exc=ShedError("batcher closed"))
                    return
            try:
                self._admit()
                if self._active:
                    self._step()
            except Exception:  # noqa: BLE001 - the worker must survive
                # per-request failure paths resolve futures themselves;
                # anything escaping here is counted and the first logged
                self.stats["worker_errors"] += 1
                if not self._worker_error_logged:
                    self._worker_error_logged = True
                    _log.exception(
                        "PagedBatcher worker step raised; continuing "
                        "(further escapes counted in "
                        "stats['worker_errors'])")
                continue

    def _take_admittable(self) -> Tuple[Optional[_PagedReq],
                                        Optional[_PagedReq]]:
        """(request to install, request to run dense), at most one each.

        FIFO with skip-ahead: a queued request that fits the free slots
        and blocks now is taken even if an earlier, larger one is still
        waiting.  A request the paged budget can never hold (too many
        rows, or prompt + generation past the block table) goes to the
        dense engine, as in the JAX batcher.
        """
        with self._cond:
            if not self._queue:
                return None, None
            free_slots = self.max_batch - sum(
                1 for s in self._slots if s is not None)
            free_budget = self.cache.num_free_blocks + self.cache.reclaimable
            for p in list(self._queue):
                if p.expired():
                    self._queue.remove(p)
                    self.stats["shed"] += 1
                    p.future.set_exception(
                        ShedError("deadline expired in queue"))
                    continue
                if p.slots_needed > self.max_batch \
                        or p.seq_len + max(p.max_new_tokens, 0) \
                        > self.cache.layout.tokens:
                    self._queue.remove(p)
                    return None, p
                need = self._blocks_need(p)
                if need > self.cache.allocator.capacity:
                    self._queue.remove(p)
                    self.stats["shed"] += 1
                    p.future.set_exception(ShedError(
                        f"request needs {need} KV blocks, pool capacity "
                        f"is {self.cache.allocator.capacity}"))
                    continue
                if p.slots_needed <= free_slots and need <= free_budget:
                    self._queue.remove(p)
                    return p, None
            return None, None

    def _run_dense(self, p: _PagedReq) -> None:
        """Oversized request: the dense engine inline (rare escape hatch)."""
        self.stats["dense_fallbacks"] += 1
        try:
            toks = p.tokens if p.fork_n <= 1 \
                else np.repeat(p.tokens, p.fork_n, axis=0)
            out = self.engine.generate(toks,
                                       max_new_tokens=p.max_new_tokens,
                                       stop_token=p.stop_token,
                                       deadline=p.deadline,
                                       sampling=p.sampling)
        except Exception as e:  # noqa: BLE001 - fail this request only
            if not p.future.done():
                p.future.set_exception(e)
            return
        if not p.future.done():
            p.future.set_result(out)

    def _blocks_need(self, p: _PagedReq) -> int:
        """Worst-case device blocks ``p`` needs over its lifetime.

        Plain requests: every row pays its full prompt + generation
        footprint.  Fork requests (``fork_n > 1``): one prompt footprint
        plus, per extra candidate, the private tail past the shared prompt
        blocks and one block for the copy-on-write of the shared boundary
        block its first divergent write touches.
        """
        per_row = self.cache.blocks_needed(
            p.seq_len + max(p.max_new_tokens, 0))
        if p.fork_n > 1:
            shared = min(-(-p.seq_len // self.cache.block_size), per_row)
            return per_row + (p.fork_n - 1) * (per_row - shared + 1)
        return per_row * p.rows

    def _admit(self) -> None:
        if self.swap:
            self._sweep_preempted()
        while True:
            req, dense = self._take_admittable()
            if dense is not None:
                self._run_dense(dense)
                continue
            if req is None and self.swap:
                req = self._admit_by_preemption()
            if req is None:
                return
            if self._active:
                self.stats["admitted_in_flight"] += 1
            try:
                if self.fused:
                    self._install(req)
                else:
                    self._prefill_blocking(req)
            except Exception as e:  # noqa: BLE001 - fail THIS request only
                self._retire(req, exc=e)

    # -- preemption / swap tier ---------------------------------------------
    def _free_slots(self) -> int:
        return self.max_batch - sum(1 for s in self._slots if s is not None)

    def _free_budget(self) -> int:
        """Blocks an allocation could get right now (free + evictable)."""
        return self.cache.num_free_blocks + self.cache.reclaimable

    def _blocks_held(self, req: _PagedReq) -> int:
        """Block references ``req`` holds — the optimistic swap-out gain."""
        return sum(len(self.cache.allocator.blocks_of((req.rid, r)))
                   for r in range(req.rows))

    def _sweep_preempted(self) -> None:
        """Shed expired paged-out requests; resume the rest that fit now,
        highest priority first (FIFO among equals)."""
        for req in list(self._preempted):
            if req.expired():
                self._retire(req, exc=ShedError(
                    "deadline expired while swapped out"))
        for req in sorted(self._preempted,
                          key=lambda r: (-r.priority, r.enqueued_at)):
            self._try_resume(req)

    def _try_resume(self, req: _PagedReq) -> bool:
        """Swap a preempted request back in if slots and blocks allow;
        all-or-nothing across rows."""
        if req.slots_needed > self._free_slots():
            return False
        need = sum(self.cache.swapped_blocks((req.rid, r))
                   for r in range(req.rows))
        if need > self._free_budget():
            return False
        tabs: List[np.ndarray] = []
        try:
            for r in range(req.rows):
                tabs.append(self.cache.swap_in((req.rid, r)))
        except CacheOOM:
            for r in range(len(tabs)):
                self.cache.swap_out((req.rid, r))
            return False
        req.tables = np.stack(tabs)
        self._take_slots(req)
        self._preempted.remove(req)
        self._active.append(req)
        self.stats["swap_ins"] += 1
        return True

    def _take_slots(self, req: _PagedReq) -> None:
        for i in range(self.max_batch):
            if len(req.slots) == req.slots_needed:
                break
            if self._slots[i] is None:
                self._slots[i] = (req, len(req.slots))
                req.slots.append(i)

    def _preempt(self, req: _PagedReq) -> None:
        """Page an active request's KV out to host and park it."""
        n = 0
        for r in range(req.rows):
            n += self.cache.swap_out((req.rid, r))
        for s in req.slots:
            self._slots[s] = None
        req.slots = []
        req.tables = None
        self._active.remove(req)
        self._preempted.append(req)
        self.stats["preemptions"] += 1
        self.stats["swapped_blocks"] += n

    def _preempt_candidate(self) -> Optional[Tuple[_PagedReq, int]]:
        """Highest-priority queued request the paged path could serve
        (FIFO among equals); returns (request, blocks needed)."""
        best: Optional[Tuple[_PagedReq, int]] = None
        with self._cond:
            for p in self._queue:
                if p.expired() or p.slots_needed > self.max_batch:
                    continue
                try:
                    need = self._blocks_need(p)
                except ValueError:
                    continue   # oversized: _take_admittable runs it dense
                if need > self.cache.allocator.capacity:
                    continue   # unsatisfiable; _take_admittable sheds it
                if best is None or p.priority > best[0].priority:
                    best = (p, need)
        return best

    def _admit_by_preemption(self) -> Optional[_PagedReq]:
        """Make room for the best queued request by paging victims out:
        strictly-lower-priority actives, lowest priority first and most
        blocks first, always whole requests."""
        cand = self._preempt_candidate()
        if cand is None:
            return None
        p, need = cand
        lower = sorted((a for a in self._active if a.priority < p.priority),
                       key=lambda a: (a.priority, -self._blocks_held(a)))
        if not lower:
            return None
        if need > self._free_budget() + sum(map(self._blocks_held, lower)) \
                or p.rows > self._free_slots() \
                + sum(len(v.slots) for v in lower):
            return None   # even paging every lower victim out can't cover
        it = iter(lower)
        while self._free_budget() < need or self._free_slots() < p.rows:
            v = next(it, None)
            if v is None:
                # prefix sharing made the optimistic bound wrong; victims
                # already paged out resume on a later sweep
                return None
            self._preempt(v)
        with self._cond:
            if p not in self._queue:
                return None   # shed behind our back (deadline race)
            self._queue.remove(p)
        return p

    def _cow_or_relieve(self, req: _PagedReq, adv: int) -> bool:
        """:meth:`_cow_writes` with pool-pressure relief: on CacheOOM page
        out the lowest-priority strictly-lower victim and retry; with none,
        self-preempt unless ``req`` is the only active request.  Returns
        False when ``req`` left the batch."""
        while True:
            try:
                self._cow_writes(req, adv)
                return True
            except CacheOOM as e:
                if not self.swap:
                    self._retire(req, exc=e)
                    return False
                lower = sorted(
                    (a for a in self._active
                     if a is not req and a.priority < req.priority),
                    key=lambda a: (a.priority, -self._blocks_held(a)))
                if lower:
                    self._preempt(lower[0])
                    continue
                if len(self._active) > 1:
                    self._preempt(req)
                    return False
                self._retire(req, exc=e)
                return False

    # -- admission install (fused path: no device work) ---------------------
    def _install(self, req: _PagedReq) -> None:
        """Give the request blocks + batch slots; with the prefix cache on,
        matched prompt blocks are shared and ``pos_next`` starts at the
        cache-hit boundary."""
        rows, t = req.rows, req.seq_len
        total = t + req.max_new_tokens
        limit = None
        row_keys: List[Optional[List[bytes]]] = [None] * rows
        if self.prefix_enabled and rows > 1:
            # lockstep rows share one pos_next: cap every row at the
            # weakest row's match so no row re-writes shared history
            row_keys = [block_keys(req.tokens[r], self.cache.block_size)
                        for r in range(rows)]
            limit = min(len(self.cache.prefix.lookup(k)) for k in row_keys)
        tabs, matched = [], []
        for r in range(rows):
            if self.prefix_enabled:
                row_tab, m_tok, _ = self.cache.allocate_prefix(
                    (req.rid, r), total, req.tokens[r], limit=limit,
                    keys=row_keys[r])
            else:
                row_tab, m_tok = self.cache.allocate((req.rid, r), total), 0
            tabs.append(row_tab)
            matched.append(m_tok)
        req.tables = np.stack(tabs)
        req.pos_next = min(matched)
        if self.spec:
            req.hist = np.zeros((rows, t + max(req.max_new_tokens, 0) + 1),
                                np.int32)
            req.hist[:, :t] = req.tokens
        if req.pos_next:
            self.stats["prefix_hits"] += rows
            self.stats["prefix_tokens_reused"] += req.pos_next * rows
        self._take_slots(req)
        self._active.append(req)

    def _cow_writes(self, req: _PagedReq, adv: int) -> None:
        """Copy-on-write any SHARED block the coming write range
        ``[pos_next, pos_next + adv)`` touches."""
        if adv <= 0 or req.tables is None \
                or not (self.prefix_enabled or req.forked):
            return  # forks share blocks even with the prefix cache off
        for r in range(req.rows):
            for idx, src, dst in self.cache.ensure_private_range(
                    (req.rid, r), req.pos_next, adv):
                self.cache.copy_block(src, dst)
                req.tables[r, idx] = dst
                self.stats["cow_copies"] += 1

    def _register_prefix(self, req: _PagedReq) -> None:
        """Index the request's fully-written full prompt blocks."""
        if self.prefix_enabled:
            for r in range(req.rows):
                self.cache.register_progress((req.rid, r), req.tokens[r],
                                             req.pos_next)

    # -- blocking chunked prefill (fused_prefill=False) ---------------------
    def _prefill_blocking(self, req: _PagedReq) -> None:
        """Same install as the fused path, then run every prompt chunk to
        completion before returning."""
        self._install(req)
        rows, t = req.rows, req.seq_len
        c = self.prefill_chunk
        logits = None
        while req.pos_next < t:
            if req.pos_next and req.expired():
                self._retire(req)
                return
            adv = min(c, t - req.pos_next)
            self._cow_writes(req, adv)   # may rewrite req.tables entries
            toks = np.zeros((rows, c), np.int32)
            toks[:, :adv] = req.tokens[:, req.pos_next:req.pos_next + adv]
            pos = np.broadcast_to(
                req.pos_next + np.minimum(np.arange(c, dtype=np.int32),
                                          adv - 1), (rows, c))
            last = np.full((rows,), adv - 1, np.int32)
            logits = self._run_step(self._step_fn, toks, req.tables, pos,
                                    last)
            self.stats["prefill_chunks"] += 1
            req.pos_next += adv
            self._register_prefix(req)
        self._finish_prefill(req, logits)

    def _finish_prefill(self, req: _PagedReq, logits: np.ndarray) -> None:
        """Prompt fully written: fork (n>1), pick the first token, retire
        if the request is already done.

        ``logits`` holds one row per REAL row (a pending fork's single
        prefill row); the fork broadcasts it to every candidate, which
        diverge only through their per-candidate draws.
        """
        if req.max_new_tokens <= 0 or req.expired():
            self._retire(req)
            return
        if req.fork_n > 1 and not req.forked:
            try:
                self._fork(req)
            except CacheOOM as e:
                self._retire(req, exc=e)
                return
            logits = np.broadcast_to(logits, (req.rows,) + logits.shape[1:])
        req.next_tok = self._next_from(req, logits, 0)
        if req.done is not None:
            req.done |= req.next_tok == req.stop_token
            req.next_tok = np.where(req.done, req.stop_token,
                                    req.next_tok).astype(np.int32)
            if bool(req.done.all()):
                self._retire(req)

    def _fork(self, req: _PagedReq) -> None:
        """Expand a prefilled single-row request to ``fork_n`` candidate
        rows that share its prompt blocks (refcounts, not copies).

        Each extra candidate shares every block the prompt occupies —
        including a partial boundary block, which its first divergent
        write copy-on-writes private — and allocates its generation tail
        fresh.  On CacheOOM the rows already forked are released, so the
        request retires holding only its prefill row.
        """
        n = req.fork_n
        tabs = [req.tables[0]]
        try:
            for r in range(1, n):
                tabs.append(self.cache.fork((req.rid, 0), (req.rid, r),
                                            shared_tokens=req.seq_len))
        except CacheOOM:
            for rr in range(1, len(tabs)):
                self.cache.release((req.rid, rr))
            raise
        req.tables = np.stack(tabs)
        req.tokens = np.repeat(req.tokens, n, axis=0)
        if req.hist is not None:
            req.hist = np.repeat(req.hist, n, axis=0)
        if req.stop_token is not None:
            # per-candidate stop: rows finish independently (unlike the
            # lockstep multi-row prompt path)
            req.done = np.zeros(n, bool)
        req.forked = True
        self.stats["forks"] += n - 1

    def _next_from(self, req: _PagedReq, logits: np.ndarray,
                   index: int) -> np.ndarray:
        """The token at output position ``index`` for every row: greedy
        argmax, or a draw through the folded-key schedule (row r of a
        forked request IS candidate r)."""
        if req.sampling.greedy:
            return logits.argmax(-1).astype(np.int32)
        return sample_tokens(logits, req.sampling, index=index)

    # -- scheduling ---------------------------------------------------------
    def _table_width(self, max_ctx: int) -> int:
        """Block-table columns needed for ``max_ctx`` tokens, rounded up to
        a power of two, capped at the layout (the tables the JAX steps see,
        so both packages pass the kernels the same shapes)."""
        need = max(1, -(-max_ctx // self.cache.block_size))
        w = 1
        while w < need:
            w <<= 1
        return min(w, self.cache.blocks_per_seq)

    def _run_step(self, fn, toks, tables, pos, last) -> np.ndarray:
        """Move one step's host arrays to the device, run ``fn`` (the pool
        is updated in place) and bring the logits back to the host."""
        dev = self.engine.device
        t, tb, ps, ls = (torch.from_numpy(np.array(a, order="C")).to(dev)
                         for a in (toks, tables, pos, last))
        out, self.cache.pool = fn(self.engine.params, t, self.cache.pool,
                                  tb, ps, ls)
        return _logits_to_host(out)

    def _call_step(self, fn, toks, tables, pos, last) -> np.ndarray:
        """:meth:`_run_step` for the shared batch: a step that raises fails
        EVERY in-flight request (their blocks return to the pool) and
        re-raises so the worker loop's error accounting sees it."""
        try:
            return self._run_step(fn, toks, tables, pos, last)
        except Exception as e:  # noqa: BLE001 - fail every member, survive
            for req in list(self._active):
                self._retire(req, exc=e)
            raise

    def _step(self) -> None:
        for req in list(self._active):   # evict expired before device work
            if req.expired():
                self._retire(req)
        self._steps_since_adjust += 1
        if self._steps_since_adjust >= self.slo_adjust_every:
            self._steps_since_adjust = 0
            self._slo_adjust()
        if not self._active:
            return
        if any(req.prefilling for req in self._active):
            self._mixed_step()
        elif self.spec:
            self._spec_step()
        else:
            self._decode_step()

    # -- fused mixed prefill/decode step ------------------------------------
    def _mixed_step(self) -> None:
        """ONE step: every decode row advances 1 token, every prefilling
        row up to ``prefill_chunk`` prompt tokens; all rows share the chunk
        width C and per-row ``last_idx`` says how many are real."""
        c = self.prefill_chunk
        b = self.max_batch
        prefilling = [r for r in self._active if r.prefilling]
        decoding = [r for r in self._active if not r.prefilling]
        n_decode = sum(r.rows for r in decoding)
        n_pf_rows = sum(r.rows for r in prefilling)
        if self.max_step_tokens > 0:
            cap = max(1, (self.max_step_tokens - n_decode)
                      // max(n_pf_rows, 1))
            cap = min(cap, c)
        else:
            cap = c
        advances = {req.rid: min(cap, req.seq_len - req.pos_next)
                    for req in prefilling}
        for req in list(prefilling):
            if not self._cow_or_relieve(req, advances[req.rid]):
                prefilling.remove(req)
        for req in list(decoding):
            if not self._cow_or_relieve(req, 1):
                decoding.remove(req)
        # relief may have paged out victims from either list
        prefilling = [r for r in prefilling if r in self._active]
        decoding = [r for r in decoding if r in self._active]
        if not prefilling and not decoding:
            return
        n_decode = sum(r.rows for r in decoding)
        max_ctx = max([req.pos_next + advances[req.rid]
                       for req in prefilling]
                      + [req.pos_next + 1 for req in decoding])
        m_used = self._table_width(max_ctx)
        toks = np.zeros((b, c), np.int32)
        tables = np.zeros((b, m_used), np.int32)  # null block for idle rows
        pos = np.zeros((b, c), np.int32)
        last = np.zeros((b,), np.int32)
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            req, r = slot
            if r >= req.rows:
                continue   # slot reserved for a not-yet-forked candidate
            tables[i] = req.tables[r][:m_used]
            if req.prefilling:
                adv = advances[req.rid]
                toks[i, :adv] = req.tokens[r, req.pos_next:req.pos_next + adv]
                # padding repeats the last valid position: keeps the
                # kernel's per-row context tight
                pos[i] = req.pos_next + np.minimum(
                    np.arange(c, dtype=np.int32), adv - 1)
                last[i] = adv - 1
            else:
                toks[i, 0] = req.next_tok[r]
                pos[i] = req.pos_next     # pads masked via last_idx == 0
        logits = self._call_step(self._step_fn, toks, tables, pos, last)
        self.stats["mixed_steps"] += 1
        self.stats["prefill_chunks"] += len(prefilling)
        if decoding:
            self.stats["decode_steps"] += 1
            self.stats["batched_rows"] += n_decode
        for req in list(decoding):
            self._advance_decode(req, logits)
        for req in list(prefilling):
            req.pos_next += advances[req.rid]
            self._register_prefix(req)
            if not req.prefilling:
                # prompt fully written: the chunk's last valid logits pick
                # the first token, and a fork expands to its candidates
                self._finish_prefill(req, logits[req.slots[:req.rows]])

    # -- speculative decode (draft-then-verify) -----------------------------
    def _draft(self, req: _PagedReq) -> Optional[np.ndarray]:
        """Per-row n-gram proposals ([rows, k] int32, lockstep rows clamped
        to their shortest proposal), or None.  The draft budget never
        exceeds the tokens the request may still emit after its pending
        one, which keeps every speculative write inside its table.  Forked
        candidates diverge row by row, so they decode plainly."""
        if req.fork_n > 1:
            return None
        budget = min(self.spec_len, req.max_new_tokens - len(req.out) - 1)
        if budget <= 0:
            return None
        hl = req.seq_len + len(req.out)
        req.hist[:, hl] = req.next_tok   # pending token caps the history
        rows = [ngram_propose(req.hist[r, :hl + 1], budget,
                              min_n=self.spec_ngram)
                for r in range(req.rows)]
        k = min(len(d) for d in rows)
        if k == 0:
            return None
        return np.stack([d[:k] for d in rows])

    def _spec_step(self) -> None:
        """Draft-then-verify decode: ONE verify step of width
        ``spec_len + 1`` scores every row's pending token plus its draft;
        rejected drafts need no undo (their positions are never committed).
        With no drafts at all, falls through to the plain decode step."""
        drafts: Dict[int, np.ndarray] = {}
        for req in self._active:
            d = self._draft(req)
            if d is not None:
                drafts[req.rid] = d
        for req in list(self._active):
            if req.expired():
                drafts.pop(req.rid, None)
                self._retire(req)
        if not self._active:
            return
        if not drafts:
            self._decode_step()
            return
        c = self.spec_len + 1
        b = self.max_batch
        for req in list(self._active):
            d = drafts.get(req.rid)
            if not self._cow_or_relieve(req, 1 + (d.shape[1] if d is not None
                                                  else 0)):
                drafts.pop(req.rid, None)
        if not self._active:
            return
        max_ctx = max(
            req.pos_next + 1 + (drafts[req.rid].shape[1]
                                if req.rid in drafts else 0)
            for req in self._active)
        m_used = self._table_width(max_ctx)
        toks = np.zeros((b, c), np.int32)
        tables = np.zeros((b, m_used), np.int32)  # null block: idle rows
        pos = np.zeros((b, c), np.int32)
        last = np.zeros((b,), np.int32)
        n_rows = 0
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            req, r = slot
            d = drafts.get(req.rid)
            k = 0 if d is None else d.shape[1]
            toks[i, 0] = req.next_tok[r]
            if k:
                toks[i, 1:1 + k] = d[r]
            pos[i] = req.pos_next + np.minimum(
                np.arange(c, dtype=np.int32), k)
            last[i] = k
            tables[i] = req.tables[r][:m_used]
            n_rows += 1
        logits = self._call_step(self._verify_fn, toks, tables, pos, last)
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        self.stats["batched_rows"] += n_rows
        for req in list(self._active):
            self._advance_spec(req, logits, drafts.get(req.rid))

    def _advance_spec(self, req: _PagedReq, logits: np.ndarray,
                      draft: Optional[np.ndarray]) -> None:
        """Commit a verify step's result for one request, then apply the
        same max_new_tokens-then-stop-token checks as
        :meth:`_advance_decode`, one emitted token at a time.

        Greedy requests accept by exact match (the prefix every row
        accepts).  Sampled requests verify by rejection sampling
        (:func:`~repro_torch.serving.sampling.rejection_sample`): the
        n-gram draft is a point mass, so draft j is accepted with
        probability p_target(draft_j) and a rejected position resamples
        from the residual; the output distribution is that of plain
        sampling.
        """
        lx = logits[req.slots]                                  # [R, C, V]
        k = 0 if draft is None else draft.shape[1]
        if req.sampling.greedy:
            argm = lx.argmax(-1).astype(np.int32)               # [R, C]
            n_acc = 0   # lockstep rows: accept the prefix EVERY row accepts
            while n_acc < k \
                    and bool((argm[:, n_acc] == draft[:, n_acc]).all()):
                n_acc += 1
            seq = [argm[:, j] for j in range(n_acc + 1)]
        else:
            n_acc, seq = self._rejection_advance(req, lx, draft, k)
        if k:
            self.stats["spec_proposed"] += k * req.rows
            self.stats["spec_accepted"] += n_acc * req.rows
        req.emit(req.next_tok.copy())
        req.pos_next += 1
        for j, new in enumerate(seq):
            if len(req.out) >= req.max_new_tokens:
                self._retire(req)
                return
            if req.done is not None:
                req.done |= new == req.stop_token
                if bool(req.done.all()):
                    self._retire(req)         # stop token not emitted
                    return
                new = np.where(req.done, req.stop_token,
                               new).astype(np.int32)
            elif req.stop_token is not None \
                    and bool((new == req.stop_token).all()):
                self._retire(req)             # stop token not emitted
                return
            if j < n_acc:
                # verified: K/V for the token is already resident
                req.emit(new.copy())
                req.pos_next += 1
            else:
                req.next_tok = new.copy()     # first unverified token
                return

    def _rejection_advance(self, req: _PagedReq, lx: np.ndarray,
                           draft: Optional[np.ndarray],
                           k: int) -> Tuple[int, List[np.ndarray]]:
        """Rejection-sample a verify step's chunk for a sampled request.

        Returns ``(n_acc, seq)``: the ``n_acc`` accepted draft columns plus
        the token that follows them, shaped like the greedy path's output.
        Lockstep rows commit the prefix every row accepts; a row that
        accepted further keeps its own draft token at the cut, and a row
        that rejected AT the cut takes its residual resample.  With no
        draft (k = 0) and for the all-accepted bonus token the draw is the
        one plain decode makes at that output index.
        """
        rows = req.rows
        base = len(req.out) + 1   # output index of the first chunk token
        if k == 0:
            return 0, [sample_tokens(lx[:, 0], req.sampling, index=base)]
        probs = target_probs(lx[:, :k + 1], req.sampling)  # [R, k+1, V]
        u = spec_uniforms(req.sampling, base_index=base, rows=rows,
                          width=k + 1)
        acc = np.zeros(rows, np.int32)
        tok = np.zeros(rows, np.int32)
        rej = np.zeros(rows, bool)
        for r in range(rows):
            acc[r], tok[r], rej[r] = rejection_sample(
                probs[r], draft[r], u[r, :, 0], u[r, :, 1])
        n_acc = int(acc.min())
        if n_acc >= k:
            # every draft accepted everywhere: the bonus token is a plain
            # categorical draw from the position after the draft
            pend = sample_tokens(lx[:, k], req.sampling, index=base + k)
        else:
            pend = np.where(acc > n_acc, draft[:, n_acc], tok) \
                .astype(np.int32)
            self.stats["spec_resamples"] += int(np.sum((acc == n_acc) & rej))
        seq = [draft[:, j] for j in range(n_acc)] + [pend]
        return n_acc, seq

    # -- decode -------------------------------------------------------------
    def _decode_step(self) -> None:
        b = self.max_batch
        for req in list(self._active):
            # decode writes rarely hit shared blocks (robustness backstop)
            self._cow_or_relieve(req, 1)
        if not self._active:
            return
        max_ctx = max(req.pos_next + 1 for req in self._active)
        m_used = self._table_width(max_ctx)
        toks = np.zeros((b, 1), np.int32)
        tables = np.zeros((b, m_used), np.int32)  # null block for idle rows
        pos = np.zeros((b,), np.int32)
        n_rows = 0
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            req, r = slot
            toks[i, 0] = req.next_tok[r]
            tables[i] = req.tables[r][:m_used]
            pos[i] = req.pos_next
            n_rows += 1
        logits = self._call_step(self._step_fn, toks, tables, pos[:, None],
                                 np.zeros((b,), np.int32))
        self.stats["decode_steps"] += 1
        self.stats["batched_rows"] += n_rows
        for req in list(self._active):
            self._advance_decode(req, logits)

    def _advance_decode(self, req: _PagedReq, logits: np.ndarray) -> None:
        """Emit the fed token, pick the next one, retire if done.

        Forked requests (``req.done`` set) stop per candidate: a row that
        picks ``stop_token`` freezes (its later picks are forced to the
        stop token) and the request retires once EVERY candidate has
        stopped, before emitting the all-stop column.
        """
        req.emit(req.next_tok.copy())
        req.pos_next += 1
        new = self._next_from(req, logits[req.slots], len(req.out))
        if len(req.out) >= req.max_new_tokens:
            self._retire(req)
            return
        if req.done is not None:
            req.done |= new == req.stop_token
            if bool(req.done.all()):
                self._retire(req)             # stop token not emitted
                return
            new = np.where(req.done, req.stop_token, new).astype(np.int32)
        elif req.stop_token is not None \
                and bool((new == req.stop_token).all()):
            self._retire(req)                 # stop token not emitted
            return
        req.next_tok = new

    # -- SLO accounting -----------------------------------------------------
    def _note_slo(self, req: _PagedReq) -> None:
        """Record observed TTFT/TPOT against the request's targets (a
        request shed before its first token still yields a TTFT)."""
        now = time.monotonic()
        if req.ttft_slo_s > 0:
            ttft = (req.first_emit_at - req.enqueued_at) \
                if req.first_emit_at is not None else now - req.enqueued_at
            self._ttft_obs.append((ttft, req.ttft_slo_s))
            if ttft > req.ttft_slo_s:
                self.stats["slo_violations"] += 1
        if req.tpot_slo_s > 0 and req.first_emit_at is not None \
                and len(req.out) > 1:
            tpot = (req.last_emit_at - req.first_emit_at) \
                / (len(req.out) - 1)
            self._tpot_obs.append((tpot, req.tpot_slo_s))
            if tpot > req.tpot_slo_s:
                self.stats["slo_violations"] += 1

    def _slo_adjust(self) -> None:
        """Halve/double the live ``max_step_tokens`` toward whichever of
        TTFT/TPOT the recent window violates more, clamped to
        [max_batch + 1, max_batch * prefill_chunk]."""
        ttft, tpot = list(self._ttft_obs), list(self._tpot_obs)
        f_ttft = sum(1 for o, t in ttft if o > t) / len(ttft) if ttft else 0.0
        f_tpot = sum(1 for o, t in tpot if o > t) / len(tpot) if tpot else 0.0
        cur = self.max_step_tokens or self._step_budget_cap
        new = cur
        if f_tpot > f_ttft and f_tpot > 0.25:
            new = max(self.max_batch + 1, cur // 2)
        elif f_ttft > f_tpot and f_ttft > 0.25:
            new = min(self._step_budget_cap, cur * 2)
        if new != cur:
            self.max_step_tokens = new
            self.stats["slo_adjustments"] += 1
            self._ttft_obs.clear()
            self._tpot_obs.clear()

    # -- retirement ---------------------------------------------------------
    def _retire(self, req: _PagedReq, *,
                exc: Optional[BaseException] = None) -> None:
        """Free ALL of the request's resources (device blocks AND any
        host swap image) and resolve its future."""
        for r in range(req.rows):
            self.cache.release((req.rid, r))
        for s in req.slots:
            self._slots[s] = None
        req.slots = []
        if req in self._active:
            self._active.remove(req)
        if req in self._preempted:
            self._preempted.remove(req)
        self._note_slo(req)
        if exc is not None:
            if not req.future.done():
                req.future.set_exception(exc)
            return
        res = np.stack(req.out, axis=1) if req.out \
            else np.zeros((req.rows, 0), np.int32)
        if req.stop_token is not None and res.size:
            hits = (res == req.stop_token).all(axis=0)
            if hits.any():
                res = res[:, :int(np.argmax(hits))]
        if not req.future.done():
            req.future.set_result(np.ascontiguousarray(res))

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=5.0)
        with self._cond:
            while self._queue:
                p = self._queue.popleft()
                if not p.future.done():
                    p.future.set_exception(ShedError("batcher closed"))
            for p in self._preempted:
                if not p.future.done():
                    p.future.set_exception(ShedError("batcher closed"))
            self._preempted.clear()

    def collect_stats(self) -> Dict[str, float]:
        """Complete snapshot: every counter in :attr:`stats` plus live
        scheduler gauges."""
        out: Dict[str, float] = dict(self.stats)
        out["active_requests"] = len(self._active)
        out["queued_requests"] = len(self._queue)
        out["preempted_requests"] = len(self._preempted)
        out["free_blocks"] = self.cache.num_free_blocks
        out["max_step_tokens"] = self.max_step_tokens
        if self.cache.prefix is not None:
            out["prefix_indexed_blocks"] = len(self.cache.prefix)
            out["prefix_evictions"] = self.cache.prefix.evictions
        return out
