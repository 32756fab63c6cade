"""Run one cell of the benchmark once and print its result line.

    python perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic mix
and metrics are named in ``BENCHMARK.json``; ``src/`` is put on the path
here.  With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics and the device's busy
time over a traced part of the window.  The last lines on standard error
and the last key of the result line are the numbers the correctness check
compared, each beside its limit.  The traffic mix's ``"loop"`` names
the module ``loops/<loop>.py`` that runs the cell.  ``--control 1`` puts
the fp8 control in the program's place (:mod:`reference.compare`): it
has to come out not correct.  Exits with another code than 0, and
prints no result, without a CUDA card, or if JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

import harness as H  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="1: the fp8 control in the program's place, judged "
                         "by the same limits (it has to come out not "
                         "correct); the benchmark's own runs leave it 0")
    return ap.parse_args(argv)


def checks(bench: H.Bench, out: dict) -> dict:
    """Each compared number beside its limit, in the order the limits
    file gives them."""
    got = {"failed": out["failed"], **out["readings"]}
    res = {}
    for name, lim in bench.limits.items():
        if name not in got:
            raise RuntimeError(f"no reading of {name!r} for its limit")
        res[name] = {"value": float(got[name]), "limit": float(lim["limit"])}
    return res


def execute(bench: H.Bench, a, dev):
    """A run of the cell on ``dev`` (its card already found): the loop
    that the traffic mix names runs it.  Returns the result line and what
    the loop returned."""
    loop = H.module_at("loops", bench.mix["loop"], bench.dir)
    out = loop.run(bench, a.seed, a.seconds, bool(a.trace), dev, T0,
                   control=bool(a.control))
    gc.collect()
    rec = out["rec"]
    if a.trace:
        metrics = H.read_per_layer(bench.per_layer(), rec, bench.dir)
    else:
        metrics = {}
        for m in bench.end_to_end():
            v = out["setup_s"] if m["name"] == "setup_s" \
                else rec["e2e"].get(m["name"])
            if v is None:
                raise RuntimeError(f"run produced no {m['name']}")
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    compared = checks(bench, out)
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": H.device_line(dev, bench.cell["chips"], out["peak"])}
    if a.trace and rec.get("trace"):
        tr = rec["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = compared
    return result, out


def main(argv=None) -> int:
    a = parse(argv)
    bench = H.Bench(ROOT, a.workload)
    src = H.find_src(ROOT)
    if src is None:
        print("no src/repro_torch in this checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    chips = bench.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result, out = execute(bench, a, dev)
    bad = H.forbidden_modules()
    if bad:
        print(f"loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 4
    what = " (the fp8 control)" if a.control else ""
    print(f"readings{what}: {json.dumps(out['readings'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}{what}: {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
