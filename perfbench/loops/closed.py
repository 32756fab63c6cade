"""The ``closed`` loop: ``clients`` callers, each sending its next request
as soon as the previous one returned (:func:`traffic.closed_plan`).

A loop module as :mod:`loops.sessions` describes: ``run``, ``drive`` and
``COUNT``.
"""
from __future__ import annotations

import itertools
import threading
import time

import traffic as TR

COUNT = "done"    # the window holds the requests that finished inside it


def run(bench, seed: int, seconds: float, trace: bool, device, t0: float,
        control: bool = False) -> dict:
    import serving
    return serving.run(bench, seed, seconds, trace, device, t0,
                       control=control)


def drive(cl) -> None:
    """The callers start together after one short request alone, run
    ``warmup.seconds`` so that every handler thread's first request is
    prefilled and decoding, and then the window opens."""
    a, mix = cl.args, cl.mix
    plan = TR.closed_plan(mix, a.seed)
    # one short request alone first: the kernels are built and loaded
    # before the warm-up's clock starts
    first = plan[0][0]
    cl.infer(TR.closed_prompt(a.seed, len(plan), 0, first.prompt, a.vocab),
             4, time.monotonic(), window=False)
    ths = [threading.Thread(target=caller, args=(cl, c, reqs), daemon=True)
           for c, reqs in enumerate(plan)]
    for th in ths:
        th.start()
    time.sleep(mix["warmup"]["seconds"])
    cl.ready()
    cl.open_at(time.monotonic())
    cl.close_at(cl.open_t + a.seconds)
    cl.stop.set()


def caller(cl, c: int, reqs) -> None:
    for i in itertools.count():
        if cl.stop.is_set():
            return
        r = reqs[i % len(reqs)]
        prompt = TR.closed_prompt(cl.args.seed, c, i, r.prompt, cl.args.vocab)
        served = cl.infer(prompt, r.new, time.monotonic(), window=True)
        if served is None and not cl.stop.is_set():
            time.sleep(0.05)
