"""The knee of a session mix: the highest arrival rate the server keeps up
with.

    python perfbench/sweep.py --workload <name> --seed <n> \\
        --seconds <s> --rates 0.2 0.3 0.45

One server, built once; one window a rate, in the order given, each from
a fresh load client whose arrivals run the mix's ``preroll_s`` before
the window opens (the first client also warms the server up).  A window
keeps up when nothing is shed or fails and no admission queue builds:
the calls waiting for one of the server's handler threads
(``Server.inflight`` less the threads), sampled every 0.25 s, average
under one over the last quarter of the window.  One JSON line a rate;
the knee is the highest rate that kept up, every rate below it keeping
up too.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import harness as H  # noqa: E402

SAMPLE_S = 0.25


def queue_builds(inflight, threads: int) -> bool:
    q = max(1, len(inflight) // 4)
    return statistics.mean(max(0, n - threads) for n in inflight[-q:]) >= 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    a = ap.parse_args(argv)
    root = HERE.parent
    bench = H.Bench(root, a.workload)
    if bench.mix["loop"] != "sessions":
        raise SystemExit("the sweep is for session mixes")
    sys.path.insert(0, str(H.find_src(root)))
    import torch
    import serving
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    loop = H.module_at("loops", "sessions", bench.dir)
    cell = serving.ServeCell(bench, a.seed, dev, time.monotonic())
    knee, all_ok = None, True
    for i, rate in enumerate(a.rates):
        client = serving.ClientProcess(bench, a.seed + i, a.seconds,
                                       bench.conf["vocab_size"], rate=rate,
                                       warmup=i == 0)

        def poll(open_t):
            out = []
            while time.monotonic() < open_t + a.seconds:
                out.append(cell.server.inflight)
                time.sleep(SAMPLE_S)
            return out
        try:
            w = cell.window(client, poll)
        finally:
            client.close()
        reqs = serving.merge(w)
        e2e = {**serving.end_to_end(w, reqs),
               **loop.ttft(reqs, w.close_t, bench.mix["drain_s"])}
        shed = w.stats1["shed"] - w.stats0["shed"]
        failed = sum(1 for r in reqs if not r["ok"])
        threads = getattr(cell.server.pool, "_max_workers", 16)
        grows = queue_builds(w.trace, threads)
        ok = not grows and shed == 0 and failed == 0
        all_ok = all_ok and ok
        if all_ok:
            knee = rate
        print(json.dumps({"rate": rate, "due": len(reqs), "failed": failed,
                          "shed": shed, "queue_builds": grows,
                          "inflight_first": w.trace[:8],
                          "inflight_last": w.trace[-8:], **e2e,
                          "batch_rows_mean": (
                              (w.stats1["batched_rows"] -
                               w.stats0["batched_rows"]) /
                              max(1, w.stats1["decode_steps"] -
                                  w.stats0["decode_steps"])),
                          "keeps_up": ok}), flush=True)
    print(json.dumps({"knee": knee}), flush=True)
    cell.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
