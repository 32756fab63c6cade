"""The ``sessions`` loop: multi-turn chat served by the port.

Sessions arrive as an open Poisson loop; the turns of one session form a
closed loop (a turn is due a think time after the previous reply
arrived), each prompt re-sending the session's system prompt and its
whole history.  The plan is :func:`traffic.session_plan`'s.

A loop module, found by the ``"loop"`` of a traffic mix, gives the
harness ``run`` (the server side: one run of a cell, in the harness's
process), the load client ``drive`` (the client side, in the client's
process) and ``COUNT``, the time by which a request belongs to the
window.  It imports the server's modules inside ``run`` only, so that
the client's process stays light.
"""
from __future__ import annotations

import threading
import time
from typing import List

import numpy as np

import traffic as TR

COUNT = "due"     # the window holds the requests due inside it


def run(bench, seed: int, seconds: float, trace: bool, device, t0: float,
        control: bool = False) -> dict:
    """A serving run (:func:`serving.run`) with this loop's tail added:
    ``ttft_p95_ms`` over every request due in the window."""
    import serving
    out = serving.run(bench, seed, seconds, trace, device, t0,
                      control=control)
    rec = out["rec"]
    rec["e2e"].update(ttft(rec["requests"], rec["close"],
                           bench.mix["drain_s"]))
    return out


def ttft(reqs: List[dict], close_t: float, drain_s: float) -> dict:
    """The 95th percentile of due to first token over every request due
    in the window; one that failed or never gave a first token counts as
    waiting until the drain gave up."""
    import harness as H
    miss = close_t + drain_s
    vals = [((r["first"] if r["ok"] and r["first"] is not None else miss)
             - r["due"]) * 1e3 for r in reqs]
    return {"ttft_p95_ms": H.percentile(vals, 95)} if vals else {}


def drive(cl) -> None:
    """System prompts first, as a deployment holds them warm; then the
    arrival process, which runs ``preroll_s`` before the window opens so
    that the window sees the session population it keeps."""
    a, mix = cl.args, cl.mix
    systems = TR.system_prompts(mix, a.seed, a.vocab)
    if a.warmup:
        ths = [threading.Thread(target=cl.infer, daemon=True,
                                args=(p, mix["warmup"]["reply"],
                                      time.monotonic(), False))
               for p in systems]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
    rate = a.rate if a.rate is not None else mix["session_rate_per_s"]
    pre = mix["preroll_s"]
    plan = TR.session_plan(mix, a.seed, pre + a.seconds, rate)
    cl.ready()
    t0 = time.monotonic()
    cl.end_t = t0 + pre + a.seconds
    opener = threading.Thread(target=cl.open_at, args=(t0 + pre,),
                              daemon=True)
    opener.start()
    threads = []
    for i, s in enumerate(plan):
        delay = t0 + s.arrival_s - time.monotonic()
        if delay > 0 and cl.stop.wait(delay):
            break
        th = threading.Thread(target=session, args=(cl, s, i, systems, t0),
                              daemon=True)
        th.start()
        threads.append(th)
    opener.join()
    cl.close_at(cl.end_t)
    deadline = cl.close_t + mix["drain_s"]
    for th in threads:
        th.join(max(0.0, deadline - time.monotonic()))


def session(cl, s: TR.Session, idx: int, systems, t0: float) -> None:
    """One session's turns, each due a think time after the last reply;
    none is sent once the window has closed."""
    a, v = cl.args, cl.args.vocab
    hist = systems[s.system]
    due = t0 + s.arrival_s
    for k, turn in enumerate(s.turns):
        if due >= cl.end_t:
            return
        user = TR.user_tokens(a.seed, idx, k, turn.user, v)
        prompt = np.concatenate([hist, user])
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        served = cl.infer(prompt, turn.reply, due, window=True)
        if served is None:
            return
        hist = np.concatenate([prompt, served])
        due = time.monotonic() + turn.think_s
