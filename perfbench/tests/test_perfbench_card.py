"""The decode-heavy cell at its own size, on a card (skipped where there
is none), through ``run.execute``:

* each planted fault (:mod:`perfbench_plant`) comes out not correct
  against the cell's own limits;
* the witness to the bf16 program's first tokens differing from the
  float32 reference's at about half of the served positions: the same
  program and traffic in float32 (the pool cut to the 16 rows that the
  server's handler threads serve at once, so that the float32 weights
  fit) sides with the reference, and in bf16 at that size it does not.

Each case prints its readings as one JSON line:
``python -m pytest perfbench/tests/test_perfbench_card.py -s``.
"""
import argparse
import json
import os
import shutil

import pytest

import harness as H
import perfbench_plant as PLANT
import run as RUN

pytestmark = pytest.mark.card
CELL = "qwen2-moe-a2.7b.decode-heavy"
ROOT = H.HERE.parent
SEEDS = (2 ** 33 + 11, 2 ** 33 + 12, 2 ** 33 + 13)


def _execute(root, cell, seed, dev):
    bench = H.Bench(root, cell)
    a = argparse.Namespace(seed=seed, seconds=float(bench.spec["run_seconds"]),
                           trace=0, control=0)
    res, out = RUN.execute(bench, a, dev)
    print(json.dumps({"cell": cell, "seed": seed, "correct": res["correct"],
                      "attempted": res["attempted"], "failed": res["failed"],
                      **out["readings"]}), flush=True)
    return res, out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", ["stale_pool", "altered_token"])
def test_fault_at_full_size_is_not_correct(card, monkeypatch, fault, seed):
    PLANT.plant(monkeypatch, fault)
    res, _ = _execute(ROOT, CELL, seed, card)
    assert not res["correct"]


@pytest.fixture(scope="module")
def witness_root(tmp_path_factory):
    """A checkout with the cell's configuration in float32 and in bf16
    under the cell's traffic, ``max_batch`` 16 and ``cache_len`` 1,024
    (prompts and outputs reach 896)."""
    root = tmp_path_factory.mktemp("witness")
    shutil.copytree(H.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(ROOT / "src", root / "src")
    pb = root / "perfbench"
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"]
                 if c["name"] == "qwen2-moe-a2.7b")
    mix = json.loads((pb / "traffic" / "decode-heavy.json").read_text())
    mix["server"].update(max_batch=16, cache_len=1024)
    (pb / "traffic" / "decode-heavy-16.json").write_text(json.dumps(mix))
    for dtype in ("float32", "bfloat16"):
        name = f"qwen2-moe-a2.7b-{dtype}"
        conf = json.loads((ROOT / entry["file"]).read_text())
        conf["torch_dtype"] = dtype
        (pb / "configs" / f"{name}.json").write_text(json.dumps(conf))
        spec["configs"].append({**entry, "name": name,
                                "file": f"perfbench/configs/{name}.json"})
        cell = f"{name}.witness"
        spec["workloads"].append({"name": cell, "config": name,
                                  "traffic": "decode-heavy-16", "chips": 1,
                                  "why": "witness"})
        shutil.copy(pb / "limits" / f"{CELL}.json",
                    pb / "limits" / f"{cell}.json")
        for m in spec["end_to_end"] + spec["per_layer"]:
            if CELL in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_program_sides_with_the_reference(card, witness_root, seed):
    res, out = _execute(witness_root, "qwen2-moe-a2.7b-float32.witness",
                        seed, card)
    r = out["readings"]
    assert res["correct"]
    assert r["served_mismatch"] < 0.05 and r["served_mean_gap"] < 0.05


def test_bfloat16_at_the_witness_size(card, witness_root):
    res, out = _execute(witness_root, "qwen2-moe-a2.7b-bfloat16.witness",
                        SEEDS[0], card)
    assert res["correct"] and out["readings"]["served_mismatch"] > 0.2
