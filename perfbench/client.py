"""The load client: one process that drives the server over TCP.

Started by the harness as ``python perfbench/client.py --traffic <mix>
--seed <n> --seconds <s> --vocab <v> [--rate <r>] [--warmup 0|1]``.  It
reads ``port <n>`` and later ``open`` on its standard input and writes
one JSON object a line on its standard output:

* ``{"ready": ...}`` once its warm-up traffic has been served;
* ``{"open": t}`` and ``{"closed": t}``: the window, on the monotonic
  clock, which every process on the machine shares;
* ``{"records": [...], "sample": [...]}`` at the end: one record per
  request of the window (its key, due, sent and done times, prompt and
  output length, success), and the prompts and served tokens of a sample
  of finished requests drawn from the seed, with the longest among them.

What it sends, and when, is the traffic mix's loop: ``drive`` of
``loops/<loop>.py``.  It sends each prompt as a Bebop page through ``Infer`` and reads the
answer's token page with the benchmark's own page codec.  A request's
key is a hash of its prompt ids, which the server side computes the same
way to tie its token times to the request.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import harness as H  # noqa: E402
import pagecodec  # noqa: E402
import traffic as TR  # noqa: E402

CALL_TIMEOUT_S = 600.0


def prompt_key(tokens: np.ndarray) -> str:
    """The key of a prompt: a hash of its ids as little-endian int32."""
    arr = np.ascontiguousarray(np.asarray(tokens).reshape(-1), dtype="<i4")
    return hashlib.blake2b(arr.tobytes(), digest_size=8).hexdigest()


class Client:
    def __init__(self, args, mix: dict):
        from repro_torch.core.rpc import Channel, TcpTransport
        from repro_torch.serving.service import InferenceService
        self.args, self.mix = args, mix
        line = sys.stdin.readline().split()
        if line[:1] != ["port"]:
            raise SystemExit(f"expected 'port <n>', got {line!r}")
        self.chan = Channel(TcpTransport.connect("127.0.0.1", int(line[1])))
        self.svc = self.chan.typed(InferenceService)
        self.lock = threading.Lock()
        self.records: List[dict] = []
        self.finished: List[dict] = []    # prompt, served, due, done
        self.open_t: Optional[float] = None
        self.close_t: Optional[float] = None
        self.end_t = float("inf")         # the window's planned close
        self.stop = threading.Event()

    # -- one request --------------------------------------------------------
    def infer(self, prompt: np.ndarray, new: int, due: float,
              window: bool) -> Optional[np.ndarray]:
        """Send ``prompt`` at ``due`` (already reached), wait for the
        answer; record it when ``window``.  Returns the served tokens, or
        None when the call failed."""
        rec = {"key": prompt_key(prompt), "due": due, "plen": len(prompt),
               "new": new, "sent": time.monotonic(), "done": None, "n": 0,
               "ok": False}
        served = None
        try:
            res = self.svc.Infer({"page": pagecodec.prompt_page(prompt[None]),
                                  "max_new_tokens": new},
                                 timeout=CALL_TIMEOUT_S)
            out = pagecodec.gen_tokens(bytes(bytearray(res["page"])), new)
            if out.shape == (1, new):
                served = out[0]
                rec["n"], rec["ok"] = new, True
        except Exception as e:  # noqa: BLE001 - a failed call is a record
            rec["error"] = f"{type(e).__name__}: {e}"[:200]
        rec["done"] = time.monotonic()
        with self.lock:
            if window:
                self.records.append(rec)
                if served is not None:
                    self.finished.append({"prompt": prompt, "served": served,
                                          "due": due, "done": rec["done"]})
        return served

    # -- window -----------------------------------------------------------------
    def ready(self) -> None:
        """Say so, and wait for the word to go on."""
        emit({"ready": time.monotonic()})
        line = sys.stdin.readline().split()
        if line[:1] != ["open"]:
            raise SystemExit(f"expected 'open', got {line!r}")

    def open_at(self, t: float) -> None:
        """Open the window at ``t``: what was recorded before is dropped."""
        delay = t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        with self.lock:
            self.open_t = t
            self.records = [r for r in self.records if r["due"] >= t]
            self.finished = [f for f in self.finished if f["due"] >= t]
        emit({"open": t})

    def close_at(self, t: float) -> None:
        delay = t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        self.close_t = t
        emit({"closed": t})

    def report(self, count: str) -> None:
        """Window records and the sample of finished requests: those whose
        ``count`` time (``"due"`` or ``"done"``, as the loop says) lies
        inside the window."""
        with self.lock:
            recs = list(self.records)
            fin = list(self.finished)
        lo, hi = self.open_t, self.close_t
        recs = [r for r in recs if lo <= r[count] < hi]
        fin = [f for f in fin if lo <= f[count] < hi]
        sample = pick_sample(fin, self.mix["sample_requests"], self.args.seed)
        emit({"records": recs,
              "sample": [{"prompt": f["prompt"].tolist(),
                          "served": f["served"].tolist()} for f in sample]})


def pick_sample(finished: list, k: int, seed: int) -> list:
    """``k`` finished requests drawn from ``seed``: the one with the
    longest prompt plus output first, the rest at random."""
    if not finished:
        return []
    longest = max(range(len(finished)),
                  key=lambda i: len(finished[i]["prompt"])
                  + len(finished[i]["served"]))
    rest = [i for i in range(len(finished)) if i != longest]
    pick = TR.rng(seed, 11).permutation(len(rest))[:max(0, k - 1)]
    return [finished[longest]] + [finished[rest[i]] for i in sorted(pick)]


def emit(obj: dict) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--vocab", type=int, required=True)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--traffic-root", required=True)
    a = ap.parse_args(argv)
    mix = TR.load_json("traffic", a.traffic, Path(a.traffic_root))
    loop = H.module_at("loops", mix["loop"], Path(a.traffic_root))
    cl = Client(a, mix)
    try:
        loop.drive(cl)
        cl.report(loop.COUNT)
    finally:
        cl.stop.set()
        cl.chan.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
