"""Deadline propagation (§7.4): absolute wall-clock timestamps, ns precision.

Every hop checks the same cutoff — no relative-timeout deduction, no rounding
accumulation.  On HTTP transports the deadline travels as a millisecond Unix
timestamp in the ``bebop-deadline`` header; on binary transports it is the
``deadline`` field of the CallHeader.  Both name the same wall-clock instant.
Copied from the JAX package's ``core/rpc/deadline.py``.
"""
from __future__ import annotations

import time
from typing import Optional

from ..types import Timestamp

HTTP_HEADER = "bebop-deadline"


class Deadline:
    __slots__ = ("ts",)

    def __init__(self, ts: Timestamp):
        self.ts = ts

    # -- constructors -------------------------------------------------------
    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        now_ns = time.time_ns()
        cut = now_ns + int(seconds * 1e9)
        return cls(Timestamp(cut // 10**9, cut % 10**9))

    @classmethod
    def from_timestamp(cls, ts: Timestamp) -> "Deadline":
        return cls(ts)

    @classmethod
    def from_http_header(cls, value: str) -> "Deadline":
        ms = int(value)
        return cls(Timestamp(ms // 1000, (ms % 1000) * 10**6))

    # -- queries -------------------------------------------------------------
    def cutoff_ns(self) -> int:
        return self.ts.sec * 10**9 + self.ts.ns

    def remaining(self) -> float:
        """Seconds until the cutoff (negative if already expired)."""
        return (self.cutoff_ns() - time.time_ns()) / 1e9

    def expired(self) -> bool:
        return time.time_ns() >= self.cutoff_ns()

    # -- propagation ---------------------------------------------------------
    def to_timestamp(self) -> Timestamp:
        return self.ts

    def to_http_header(self) -> str:
        return str(self.cutoff_ns() // 10**6)

    def __repr__(self):
        return f"Deadline(+{self.remaining():.3f}s)"


def deadline_from_call(header: dict) -> Optional[Deadline]:
    ts = header.get("deadline")
    if ts is None:
        return None
    return Deadline(ts)
