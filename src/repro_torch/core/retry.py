"""Shared retry policy: one backoff implementation for every layer.

Copied unchanged from the JAX package's ``core/retry.py`` (JAX-free host
code): the port's ``ResilientChannel`` reconnects under it.

Both the training loop's transient-I/O wrapper (``train/fault.py``) and
the serving client's reconnect path (``core/rpc/client.ResilientChannel``)
retry the same way: bounded attempts, exponential backoff with a cap, and
optional jitter so a fleet of clients reconnecting after one outage does
not stampede the server in lockstep.  The policy is a frozen value object
so call sites can share instances; the sleep and RNG are injectable so
tests run in zero wall-clock time and deterministically.
"""
from __future__ import annotations

import dataclasses
import random as _random
import time
from typing import Callable, Optional, Tuple, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """attempts / base_delay / multiplier / max_delay cap / jitter / filter.

    ``delay(k)`` is the pause before retry ``k`` (k counts from 1):
    ``min(base_delay * multiplier**(k-1), max_delay)``, scaled by a
    uniform factor in ``[1-jitter, 1+jitter]`` when jitter > 0.
    """

    attempts: int = 4
    base_delay: float = 0.1
    multiplier: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.0          # fraction of the delay, uniform both ways
    retry_on: Tuple[type, ...] = (IOError, OSError, ConnectionError)

    def delay(self, attempt: int,
              rng: Optional[_random.Random] = None) -> float:
        """Backoff before retry ``attempt`` (1-based), jittered."""
        d = min(self.base_delay * self.multiplier ** max(attempt - 1, 0),
                self.max_delay)
        if self.jitter > 0:
            r = (rng or _random).uniform(1.0 - self.jitter, 1.0 + self.jitter)
            d *= max(r, 0.0)
        return d

    def retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retry_on)


def retry(fn: Callable[[], T], *, policy: Optional[RetryPolicy] = None,
          attempts: Optional[int] = None, base_delay: Optional[float] = None,
          retry_on: Optional[Tuple[type, ...]] = None,
          sleep: Callable[[float], None] = time.sleep,
          rng: Optional[_random.Random] = None) -> T:
    """Run ``fn`` under ``policy`` (keyword overrides build a derived one).

    The historical ``train.fault.retry(fn, attempts=, base_delay=,
    retry_on=)`` signature maps onto the default policy unchanged: the
    old uncapped doubling never exceeded the 2.0s cap within its default
    4 attempts.
    """
    p = policy or RetryPolicy()
    overrides = {}
    if attempts is not None:
        overrides["attempts"] = attempts
    if base_delay is not None:
        overrides["base_delay"] = base_delay
    if retry_on is not None:
        overrides["retry_on"] = tuple(retry_on)
    if overrides:
        p = dataclasses.replace(p, **overrides)
    last: Optional[BaseException] = None
    for i in range(max(p.attempts, 1)):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - filtered right below
            if not p.retryable(e):
                raise
            last = e
            if i == p.attempts - 1:
                raise
            sleep(p.delay(i + 1, rng))
    raise last if last is not None else AssertionError("unreachable")
