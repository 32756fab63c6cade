"""Fault tolerance for the training loop.

A copy of the JAX package's ``train/fault.py`` (JAX-free host code).

  * PreemptionHandler: SIGTERM/SIGINT -> set a flag the loop checks each
    step; the loop writes an emergency checkpoint and exits cleanly.
    (Cloud preemptions deliver SIGTERM with some seconds of grace.)
  * retry: exponential-backoff wrapper for transient I/O (page reads,
    checkpoint writes to remote stores).  Re-exported from
    ``core/retry.py`` — the serving client's reconnect path shares the
    same policy implementation (attempts, base delay, cap, jitter,
    retryable-exception filter).
  * StepWatchdog: detects hung steps (collective deadlock after a peer
    failure) and raises so the supervisor can restart the worker; on a
    multi-pod deployment the runner restarts from the last checkpoint and
    the data cursor guarantees no example is skipped or repeated.
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Optional

from ..core.retry import RetryPolicy, retry  # noqa: F401 - compat re-export


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._flag = threading.Event()
        self._prev = {}
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:  # non-main thread (tests)
                pass
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        self._flag.set()

    def trigger(self) -> None:  # for tests
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()


class StepWatchdog:
    """Raises (via callback) if a step exceeds ``timeout_s`` — the symptom
    of a peer failure stalling a collective."""

    def __init__(self, timeout_s: float,
                 on_hang: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_hang = on_hang
        self._deadline: Optional[float] = None  # guarded by _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.hung = False
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="step-watchdog")
        self._thread.start()

    def step_started(self) -> None:
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s

    def step_finished(self) -> None:
        with self._lock:
            self._deadline = None

    def _watch(self) -> None:
        while not self._stop.wait(min(self.timeout_s / 4, 1.0)):
            with self._lock:
                d = self._deadline
            if d is not None and time.monotonic() > d:
                self.hung = True
                if self.on_hang is not None:
                    self.on_hang()
                with self._lock:
                    self._deadline = None

    def stop(self) -> None:
        self._stop.set()
