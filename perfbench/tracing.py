"""The traced window: ``torch.profiler`` over part of a run, reduced to
the device's busy time, kernel time by name, and the idle gaps.

The idle arithmetic is that of ``chip_smoke.py``'s profile phase (busy
time of the device operations against the wall time of the window),
with the device intervals merged first, so that work on two streams is
not counted twice.
"""
from __future__ import annotations

import re
import sys
import time
from typing import Dict, List, Tuple

# kernel families the per-layer metrics read, by a pattern on the name
KERNELS = {
    "paged_decode": re.compile(r"paged_attention_\w*kernel<[^>]*true>"),
    "paged_prefill": re.compile(r"paged_attention_\w*kernel<[^>]*false>"),
}


class Traced:
    """A profiler run: the profiler and its bounds on two clocks."""

    def __init__(self, prof, mono: Tuple[float, float],
                 epoch_ns: Tuple[int, int]):
        self.prof, self.mono, self.epoch_ns = prof, mono, epoch_ns


def trace(seconds: float, start_at: float) -> Traced:
    """Profile every thread's work from ``start_at`` (monotonic) for
    ``seconds``."""
    from torch.profiler import ProfilerActivity, profile
    try:
        from torch._C._profiler import _ExperimentalConfig
        # the model runs on the batcher's worker thread, not this one
        extra = {"experimental_config":
                 _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        extra = {}
    delay = start_at - time.monotonic()
    if delay > 0:
        time.sleep(delay)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   **extra)
    prof.start()
    m0, n0 = time.monotonic(), time.time_ns()
    time.sleep(seconds)
    m1, n1 = time.monotonic(), time.time_ns()
    prof.stop()
    return Traced(prof, (m0, m1), (n0, n1))


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(t: Traced, top: int = 10) -> dict:
    """busy_s, window_s, kernel seconds by family and by name, and the
    longest idle gaps named by the host activity inside them."""
    from torch.autograd import DeviceType
    events = t.prof.profiler.kineto_results.events()
    lo, hi = t.epoch_ns
    dev, host = [], []
    for e in events:
        s = e.start_ns()
        d = e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((s, s + d, e.name()))
        elif d > 0:
            host.append((s, s + d, e.name()))
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in dev
              if b > lo and a < hi]
    if dev and not inside:       # another timebase: keep the events whole
        inside = dev
    merged = _union([(a, b) for a, b, _ in inside])
    busy = sum(b - a for a, b in merged) / 1e9
    by_name: Dict[str, float] = {}
    families = {k: 0.0 for k in KERNELS}
    counts = {k: 0 for k in KERNELS}
    for a, b, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        for k, pat in KERNELS.items():
            if pat.search(n):
                families[k] += (b - a) / 1e9
                counts[k] += 1
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:top]
    print(f"trace: {len(dev)} device and {len(host)} host events, "
          f"{len(inside)} device events inside the window, "
          f"kernel calls {counts}", file=sys.stderr, flush=True)
    return {"busy_s": busy, "window_s": t.mono[1] - t.mono[0],
            "start": t.mono[0], "stop": t.mono[1],
            "kernels": families, "kernel_calls": counts,
            "device_ops": [[n[:120], s] for n, s in
                           sorted(by_name.items(), key=lambda kv: -kv[1])
                           [:top]],
            "idle_gaps": [[_host_label(host, a, b), g / 1e9]
                          for g, a, b in gaps]}


def _host_label(host, a: int, b: int) -> str:
    """The shortest host event that covers at least half of [a, b]."""
    best, best_d = None, None
    need = (b - a) / 2
    for s, e, n in host:
        if e <= a or s >= b:
            continue
        if min(e, b) - max(s, a) >= need and (best_d is None
                                              or e - s < best_d):
            best, best_d = n, e - s
    return (best or "host: no recorded operation")[:120]
