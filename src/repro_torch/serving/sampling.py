"""Token-selection parameters: the greedy part of the JAX package's
``serving/sampling.py``.

:class:`SamplingParams`, :data:`GREEDY` and the typed request schema
:class:`GenerationParams` keep the JAX validation rules.  Sampled decode
(temperature > 0) draws its uniforms from ``jax.random``'s threefry key
schedule, which the port must reproduce bit for bit before it can serve
such requests; until then a temperature above 0 raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.rpc import RpcError, Status

_SAMPLED_TODO = ("temperature > 0 (seeded sampling) is not ported yet: it "
                 "needs a threefry2x32 bit-identical to jax.random "
                 "(ROADMAP.md, Queue 1: sampling)")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """One request's resolved sampling configuration.

    ``temperature <= 0`` means greedy argmax; ``top_k = 0`` and
    ``top_p = 1.0`` disable the filters; ``seed`` feeds the sampler's key
    schedule.  Only greedy is served by the port so far.
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
        if self.temperature > 0:
            raise NotImplementedError(_SAMPLED_TODO)

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


#: the default request: plain greedy decode.
GREEDY = SamplingParams()


@dataclasses.dataclass(frozen=True)
class GenerationParams:
    """The typed request schema every generation entry point shares.

    * **Absent field -> None here -> the serving default applies
      downstream** (``default_max_new`` for ``max_new_tokens``, the
      ``ServeConfig`` sampling and scheduling defaults for the rest).
    * **Explicit value -> itself, even when falsy**: ``max_new_tokens=0``
      is a prefill-only request, ``temperature=0.0`` forces greedy.
    * **``stop_token`` keeps the wire's negative sentinel**: any value
      < 0 means "no stop token".
    * ``n`` defaults to 1.

    :meth:`from_request` is the single validator — malformed values raise
    ``RpcError(INVALID_ARGUMENT)`` before any engine work starts.
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
