"""Stochastic sampling: temperature / top-k / top-p, seeded and batchable.

A port of the JAX package's ``serving/sampling.py``.  The randomness that
decides the token at output index ``m`` of candidate row ``c`` of a request
seeded ``s`` is

    ``uniform(fold_in(fold_in(PRNGKey(s), m), c))``

and the residual (or bonus) draw of speculative verification takes that
key's ``fold_in(..., 1)`` twin: a pure function of ``(s, m, c)``, so a
request's tokens do not depend on batch composition, on the dense or paged
engine, or on a stream's resume point.  The token is the inverse CDF of the
filtered (temperature / top-k / top-p) distribution at that uniform.

The JAX package draws these uniforms with ``jax.random`` (threefry2x32).
This module computes the same bits in numpy: :func:`_threefry2x32` is the
20-round Threefry-2x32 block cipher, :func:`_fold_in` and
:func:`_uniform_bits` follow ``jax.random``'s key derivation and its
float32 build from the top 23 bits.  The bit layout is that of
``jax_threefry_partitionable = True`` (the default of the jax the reference
tests run against, 0.9.0): a scalar ``uniform`` hashes the counter pair
``(0, 0)`` and XORs the two output words.  The window of 64 indices is one
vectorised call, cached per ``(seed, window, candidates)`` as the
reference caches its jitted block.  Everything here runs on the host, as
the reference's filter and CDF walk do; there is no device kernel behind
it.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np

from ..core.rpc import RpcError, Status


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """One request's resolved sampling configuration.

    ``temperature <= 0`` means greedy argmax — the sampler is bypassed
    entirely and the engine runs its original argmax lines, so greedy
    output is bit-identical to the pre-sampling engine by construction,
    not by numerical luck.  ``top_k = 0`` disables the top-k filter,
    ``top_p = 1.0`` disables the nucleus filter, and ``seed`` feeds the
    folded key schedule in the module docstring.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


#: the default request: plain greedy decode, exactly as before.
GREEDY = SamplingParams()


# -- threefry2x32, as jax.random computes it ----------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(k0, k1, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds on uint32 arrays (broadcast together):
    key ``(k0, k1)``, counter words ``(x0, x1)``; returns the two output
    words.  uint32 arithmetic wraps, as the cipher needs."""
    k0, k1 = np.asarray(k0, np.uint32), np.asarray(k1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _fold_in(k0, k1, data) -> Tuple[np.ndarray, np.ndarray]:
    """``jax.random.fold_in``: hash the counter ``(0, data)`` under the key
    (``threefry_seed`` of a 32-bit value is the pair ``(0, value)``)."""
    return _threefry2x32(k0, k1, np.uint32(0), np.asarray(data, np.uint32))


def _uniform_bits(k0, k1) -> np.ndarray:
    """``jax.random.uniform(key)`` (float32, [0, 1)) as its uint32 bits:
    32 random bits from the counter ``(0, 0)`` (the two words XORed), their
    top 23 as the mantissa of a float in [1, 2), minus 1."""
    b0, b1 = _threefry2x32(k0, k1, np.uint32(0), np.uint32(0))
    one = np.uint32(0x3F800000)
    f = (((b0 ^ b1) >> np.uint32(9)) | one).view(np.float32) - np.float32(1)
    return f.view(np.uint32)


def _uniforms(seed: int, base_index: int, rows: int, width: int
              ) -> np.ndarray:
    """``[rows, width, 2]`` float32: (accept, resample) uniforms of output
    indices ``base_index .. base_index + width - 1`` for candidates
    ``0 .. rows - 1``."""
    c = np.arange(rows, dtype=np.uint32)[:, None]
    j = (np.uint32(base_index) + np.arange(width, dtype=np.uint32))[None, :]
    k0, k1 = _fold_in(np.uint32(0), np.uint32(seed), j)     # PRNGKey, index
    k0, k1 = _fold_in(k0, k1, c)                             # candidate
    u0 = _uniform_bits(k0, k1)
    u1 = _uniform_bits(*_fold_in(k0, k1, 1))
    return np.stack([u0, u1], axis=-1).view(np.float32)


#: output indices covered per materialized uniform block: one vectorised
#: ``_uniforms`` call serves the next 64 tokens of a request, so the
#: per-token sampling cost is the filter and CDF walk alone.
_WINDOW = 64
_UCACHE_MAX = 128     # (seed, window, cands) blocks kept; tiny ([c, 64, 2])
_ucache: "collections.OrderedDict[tuple, np.ndarray]" = \
    collections.OrderedDict()
_ucache_lock = threading.Lock()


def _uniform_window(seed: int, base: int, cands: int) -> np.ndarray:
    """The cached ``[cands, _WINDOW, 2]`` uniform block starting at
    ``base`` (a multiple of ``_WINDOW``) for candidates ``0..cands-1``."""
    key = (int(seed), int(base), int(cands))
    with _ucache_lock:
        w = _ucache.get(key)
        if w is not None:
            _ucache.move_to_end(key)
            return w
    w = _uniforms(int(seed), int(base), int(cands), _WINDOW)
    with _ucache_lock:
        _ucache[key] = w
        while len(_ucache) > _UCACHE_MAX:
            _ucache.popitem(last=False)
    return w


def _uniform_at(seed: int, index: int, rows: int,
                cand0: int = 0) -> np.ndarray:
    """``[rows, 2]`` (accept, resample) uniforms for output ``index`` of
    candidates ``cand0..cand0+rows-1``."""
    base = (int(index) // _WINDOW) * _WINDOW
    w = _uniform_window(seed, base, cand0 + rows)
    return w[cand0:cand0 + rows, index - base]


def _host_probs(logits: np.ndarray, params: SamplingParams) -> np.ndarray:
    """Filtered sampling distribution, ``[R, V]`` float64.

    Temperature scaling, then top-k (keep logits >= the k-th largest,
    ties included; k = 0 disables), then top-p: keep the smallest
    descending-sorted set with mass >= ``top_p``, via the EXCLUSIVE
    prefix sum — every token whose cumulative mass *before* it is under
    the threshold survives, so the top token always does and the kept
    mass reaches at least ``top_p``.
    """
    x = np.asarray(logits, np.float64) / max(params.temperature, 1e-6)
    rows, vocab = x.shape
    if params.top_k > 0:
        k = min(params.top_k, vocab)
        kth = np.partition(x, vocab - k, axis=-1)[:, vocab - k, None]
        x = np.where(x >= kth, x, -np.inf)
    if params.top_p < 1.0:
        order = np.argsort(-x, axis=-1, kind="stable")
        xs = np.take_along_axis(x, order, axis=-1)
        es = np.exp(xs - xs[:, :1])
        ps = es / es.sum(-1, keepdims=True)
        keep_sorted = (np.cumsum(ps, axis=-1) - ps) < params.top_p
        keep = np.zeros_like(keep_sorted)
        np.put_along_axis(keep, order, keep_sorted, axis=-1)
        x = np.where(keep, x, -np.inf)
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def sample_tokens(logits, params: SamplingParams, *, index: int,
                  cand0: int = 0) -> np.ndarray:
    """Next token per row: ``[R, V]`` logits -> ``[R]`` int32.

    ``index`` is the output position being decided (0 = the first
    generated token) and ``cand0`` the candidate id of row 0 — together
    with ``params.seed`` they pin down the key schedule, so the result
    is independent of batch composition and identical across the paged
    and dense engines.  Greedy params short-circuit to plain argmax.
    """
    if params.greedy:
        return np.asarray(np.argmax(logits, -1), np.int32)
    probs = _host_probs(np.atleast_2d(np.asarray(logits)), params)
    u = _uniform_at(params.seed, index, probs.shape[0], cand0)
    return np.asarray([_inverse_cdf(p, float(uu[0]))
                       for p, uu in zip(probs, u)], np.int32)


def target_probs(logits, params: SamplingParams) -> np.ndarray:
    """The request's *sampling distribution* at each position.

    ``[..., V]`` logits -> ``[..., V]`` probabilities with temperature,
    top-k and top-p applied — what :func:`sample_tokens` actually draws
    from, and therefore what speculative verification must accept/reject
    against (rejection sampling is only distribution-preserving when p
    is the filtered target, not the raw softmax).
    """
    arr = np.asarray(logits)
    flat = arr.reshape(-1, arr.shape[-1])
    return _host_probs(flat, params).reshape(arr.shape)


def spec_uniforms(params: SamplingParams, *, base_index: int, rows: int,
                  width: int) -> np.ndarray:
    """Accept/resample uniforms for one verify step: ``[rows, width, 2]``.

    ``[:, j, 0]`` drives the accept test for the token at output index
    ``base_index + j``; ``[:, j, 1]`` drives the residual (or bonus)
    draw at the same index.  Keys follow the module's schedule (served
    from the same window cache as :func:`sample_tokens`), so the draws
    for an index are fixed by (seed, index, row) alone.
    """
    return np.stack([_uniform_at(params.seed, base_index + j, int(rows))
                     for j in range(int(width))], axis=1)


def _inverse_cdf(p: np.ndarray, u: float) -> int:
    """Draw from distribution ``p`` via its CDF at uniform ``u``."""
    cdf = np.cumsum(p)
    cdf[-1] = max(cdf[-1], 1.0)   # float shortfall at the top never OOBs
    return int(np.searchsorted(cdf, u, side="right"))


def rejection_sample(probs: np.ndarray, draft: np.ndarray,
                     u_accept: np.ndarray, u_resample: np.ndarray
                     ) -> Tuple[int, int, bool]:
    """One row of rejection-sampled draft verification (SpecInfer rule).

    ``probs [k+1, V]``: the filtered target distribution at each verify
    position; ``draft [k]``: the proposed tokens; the uniforms drive the
    accept tests and the fallback draws.  Returns ``(n_acc, token,
    resampled)`` — the accepted prefix length, the pending token at
    position ``n_acc`` (a residual resample on rejection, the bonus
    sample from ``probs[k]`` when every draft was accepted), and whether
    that token came from a residual.

    The n-gram drafter is deterministic, i.e. a point mass ``q`` at the
    draft token, so the general accept rule ``u < min(1, p/q)`` reduces
    to accepting with probability ``p(draft)`` and the residual
    ``max(0, p - q)/Z`` to ``p`` with the draft token zeroed out.  The
    emitted marginal is exactly ``p`` at every position — speculation
    changes throughput, never the distribution.  At temperature 0 ``p``
    is itself a point mass at the argmax, and accept-iff-argmax==draft /
    resample==argmax falls out as the special case — which is why the
    engine's greedy path can keep its exact-match loop bit-identically.
    """
    k = int(len(draft))
    for j in range(k):
        p = probs[j]
        if float(u_accept[j]) < float(p[int(draft[j])]):
            continue                       # accepted: emit the draft token
        resid = np.asarray(p, np.float64).copy()
        resid[int(draft[j])] = 0.0
        z = float(resid.sum())
        if z <= 1e-12:
            continue   # target IS the draft's point mass: nothing to reject
        return j, _inverse_cdf(resid / z, float(u_resample[j])), True
    return k, _inverse_cdf(np.asarray(probs[k], np.float64),
                           float(u_resample[k])), False


@dataclasses.dataclass(frozen=True)
class GenerationParams:
    """The typed request schema every generation entry point shares.

    One validated object replaces the per-handler dict fishing that used
    to live in ``service.py`` (``Infer`` checked ``"max_new_tokens" in
    req``, ``InferStream`` used ``.get(..., 16)``, ``Generate`` turned
    an explicit 0 into the engine default via ``int(...) or None`` —
    three handlers, three semantics).  The rulebook, once:

    * **Absent field -> None here -> the serving default applies
      downstream**: the handler's ``default_max_new`` for
      ``max_new_tokens``; ``ServeConfig.temperature`` / ``top_k`` /
      ``top_p`` / ``seed`` for sampling; ``default_priority`` and the
      SLO targets for scheduling.
    * **Explicit value -> itself, even when falsy**: ``max_new_tokens=0``
      is a prefill-only request (zero generated tokens, success),
      ``temperature=0.0`` forces greedy, ``seed=0`` is a real seed.
    * **``stop_token`` keeps the wire's negative sentinel**: any value
      < 0 (the encoded default is -1) means "no stop token".
    * ``n`` defaults to 1; ``n > 1`` asks for n sampled candidates of a
      single-row prompt (the paged engine forks them to share the
      prompt's KV blocks).

    :meth:`from_request` is the single validator — malformed values
    raise ``RpcError(INVALID_ARGUMENT)`` before any engine work starts,
    identically from every handler.
    """

    max_new_tokens: Optional[int] = None
    stop_token: Optional[int] = None
    priority: Optional[int] = None
    ttft_slo_ms: Optional[float] = None
    tpot_slo_ms: Optional[float] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None
    n: int = 1

    @classmethod
    def from_request(cls, req: dict, *,
                     default_max_new: Optional[int] = 16
                     ) -> "GenerationParams":
        """Validate + normalize one decoded request dict (see class doc)."""
        def opt(name, cast):
            return cast(req[name]) if name in req else None

        maxn = opt("max_new_tokens", int)
        stop = opt("stop_token", int)
        gp = cls(
            max_new_tokens=default_max_new if maxn is None else maxn,
            stop_token=stop if stop is not None and stop >= 0 else None,
            priority=opt("priority", int),
            ttft_slo_ms=opt("ttft_slo_ms", float),
            tpot_slo_ms=opt("tpot_slo_ms", float),
            temperature=opt("temperature", float),
            top_k=opt("top_k", int),
            top_p=opt("top_p", float),
            seed=opt("seed", int),
            n=int(req.get("n", 1)))
        gp.validate()
        return gp

    def validate(self) -> "GenerationParams":
        def bad(msg):
            raise RpcError(Status.INVALID_ARGUMENT, msg)

        if self.max_new_tokens is not None and self.max_new_tokens < 0:
            bad(f"max_new_tokens must be >= 0, got {self.max_new_tokens}")
        if self.temperature is not None and self.temperature < 0:
            bad(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k is not None and self.top_k < 0:
            bad(f"top_k must be >= 0, got {self.top_k}")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            bad(f"top_p must be in (0, 1], got {self.top_p}")
        if self.n < 1:
            bad(f"n must be >= 1, got {self.n}")
        return self

    def sampling(self, defaults) -> SamplingParams:
        """Resolve against a ``ServeConfig``-shaped default provider."""
        return SamplingParams(
            temperature=(defaults.temperature if self.temperature is None
                         else self.temperature),
            top_k=defaults.top_k if self.top_k is None else self.top_k,
            top_p=defaults.top_p if self.top_p is None else self.top_p,
            seed=defaults.seed if self.seed is None else self.seed)
