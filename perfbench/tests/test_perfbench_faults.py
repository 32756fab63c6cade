"""The harness's correctness check catches a broken timed path: runs of
tiny serving cells on the CPU through ``run.execute`` (the look for a card
skipped), sound; with a step that leaves the K/V pool unchanged; with a
token altered where the batcher produces it; and with the fp8 control in
the program's place.  Also a new cell, traffic loop, mix and metric, and
a new model family, added as files only."""
import argparse
import json

import pytest
import torch

import harness as H
import perfbench_plant as PLANT
import perfbench_tiny as TINY
import run as RUN


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return TINY.make(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seconds=3.0, trace=False, control=False):
    bench = H.Bench(root, cell)
    a = argparse.Namespace(seed=2 ** 32 + 9, seconds=seconds,
                           trace=int(trace), control=int(control))
    return RUN.execute(bench, a, torch.device("cpu"))


def test_sound_runs_are_correct_and_report_their_metrics(root):
    res, out = _run(root, "tiny.chat", trace=True)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert out["readings"]["served_gap"] <= 1e-3
    assert out["readings"]["tokens"] > 0
    assert set(out["rec"]["e2e"]) >= {"ttft_p95_ms", "tpot_p95_ms"}
    assert {"prefix_reuse_share", "batch_rows_mean.chat",
            "step_mfu.chat"} <= set(res["metrics"])
    assert 0 < res["metrics"]["prefix_reuse_share"]["value"] < 100
    res, _ = _run(root, "tiny.heavy")
    assert res["correct"]
    assert res["metrics"]["serve_tokens_per_s"]["value"] > 0


def _fails_with(root, monkeypatch, fault, cell):
    PLANT.plant(monkeypatch, fault)
    res, out = _run(root, cell)
    assert not res["correct"] and out["readings"]["served_gap"] > 1e-3


def test_stale_state_fails(root, monkeypatch):
    _fails_with(root, monkeypatch, "stale_pool", "tiny.heavy")


def test_altered_token_fails(root, monkeypatch):
    _fails_with(root, monkeypatch, "altered_token", "tiny.chat")


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.heavy"])
def test_the_control_is_not_correct(root, cell):
    """The fp8 control, judged by the cell's own limits in the program's
    place, fails them."""
    res, out = _run(root, cell, control=True)
    assert not res["correct"]
    assert res["checks"]["served_gap"]["value"] > \
        res["checks"]["served_gap"]["limit"]


BURST_LOOP = '''
"""All the clients' first requests at once, a burst, then the window
closes."""
import threading
import time

import traffic as TR

COUNT = "done"


def run(bench, seed, seconds, trace, device, t0, control=False):
    import serving
    return serving.run(bench, seed, seconds, trace, device, t0,
                       control=control)


def drive(cl):
    a = cl.args
    plan = TR.closed_plan(cl.mix, a.seed)
    cl.ready()
    cl.open_at(time.monotonic())
    ths = [threading.Thread(target=cl.infer, args=(
        TR.closed_prompt(a.seed, c, 0, reqs[0].prompt, a.vocab),
        reqs[0].new, time.monotonic(), True)) for c, reqs in enumerate(plan)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    cl.close_at(time.monotonic() + 0.01)
'''


def test_a_new_cell_needs_only_new_files(root):
    """A cell, a traffic loop, a mix and a per-layer metric added as new
    files, and an entry each in BENCHMARK.json: found by name and run,
    nothing edited."""
    pb = root / "perfbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    spec_before = (root / "BENCHMARK.json").read_text()
    mix = json.loads((pb / "traffic" / "tiny-heavy.json").read_text())
    mix.update(loop="burst", clients=3)
    new = {pb / "traffic" / "tiny-burst.json": json.dumps(mix),
           pb / "loops" / "burst.py": BURST_LOOP,
           pb / "metrics" / "requests_done.burst.py":
               'LAYER = "Service"\nUNIT = "requests"\n'
               'MOVES = "serve_tokens_per_s"\n\n\ndef read(rec):\n'
               '    reqs = rec.get("requests")\n'
               '    return None if reqs is None else float(len(reqs))\n',
           pb / "limits" / "tiny.burst.json":
               (pb / "limits" / "tiny.heavy.json").read_text()}
    try:
        for p, text in new.items():
            p.write_text(text)
        spec = json.loads(spec_before)
        spec["workloads"].append({"name": "tiny.burst", "config": "tiny-moe",
                                  "traffic": "tiny-burst", "chips": 1,
                                  "why": "test"})
        spec["per_layer"].append({
            "name": "requests_done.burst", "unit": "requests",
            "better": "higher", "source": "host_clock", "layer": "Service",
            "moves": "serve_tokens_per_s", "workloads": ["tiny.burst"]})
        for m in spec["end_to_end"]:
            if m["name"] == "serve_tokens_per_s":
                m["workloads"].append("tiny.burst")
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
        res, _ = _run(root, "tiny.burst", trace=True)
        assert res["correct"] and res["attempted"] == 3
        assert res["metrics"]["requests_done.burst"] == {
            "value": 3.0, "unit": "requests"}
        res, _ = _run(root, "tiny.burst")
        assert set(res["metrics"]) == {"serve_tokens_per_s", "setup_s"}
        after = {p: p.read_bytes() for p in before}
        assert after == before
    finally:
        for p in new:
            p.unlink(missing_ok=True)
        (root / "BENCHMARK.json").write_text(spec_before)


PLANTED_FAMILY = '''
"""The Qwen2 family, judged by a reference whose logit of the first
served token of the first sampled request lies ``SHIFT`` lower."""
from pathlib import Path

import harness as H
from reference import compare as C
from reference import decoder as D

SHIFT = {shift}
_QWEN2 = H.module_at("families", "qwen2", Path(__file__).resolve().parents[1])
port_config = _QWEN2.port_config
leaf_specs = _QWEN2.leaf_specs
counts = _QWEN2.counts


def readings(params, conf, server, sample, *, control, device):
    D.strict_float32()
    seqs, at, served = C.inputs(sample, device)
    ref = D.logits_at(params, D.Arch.from_config(conf), seqs, at)
    ref[0][0, served[0][0]] -= SHIFT
    return C.gaps(ref, served)
'''


def test_a_new_family_needs_only_new_files(root):
    """A configuration whose ``model_type`` no family of the tree has, its
    family module and a cell under the closed loop, added as new files
    and entries: the family's own reference judges the run.  It plants a
    shift of the reference's logits at one served position, and the run
    comes out not correct; with the shift at 0 it comes out correct."""
    pb = root / "perfbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    spec_before = (root / "BENCHMARK.json").read_text()
    conf = json.loads((pb / "configs" / "tiny-dense.json").read_text())
    conf["model_type"] = "qwen2_planted"
    family = pb / "families" / "qwen2_planted.py"
    new = {pb / "configs" / "tiny-planted.json": json.dumps(conf),
           pb / "limits" / "tiny.planted.json":
               (pb / "limits" / "tiny.heavy.json").read_text()}
    try:
        for p, text in new.items():
            p.write_text(text)
        spec = json.loads(spec_before)
        spec["configs"].append({
            "name": "tiny-planted", "source": "test",
            "file": "perfbench/configs/tiny-planted.json", "reduced": [],
            "why": "test"})
        spec["workloads"].append({
            "name": "tiny.planted", "config": "tiny-planted",
            "traffic": "tiny-heavy", "chips": 1, "why": "test"})
        for m in spec["end_to_end"]:
            if m["name"] == "serve_tokens_per_s":
                m["workloads"].append("tiny.planted")
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
        # the two texts differ in length, so no stale bytecode is loaded
        family.write_text(PLANTED_FAMILY.format(shift="100.0"))
        res, out = _run(root, "tiny.planted")
        assert res["failed"] == 0 and res["attempted"] > 0
        assert not res["correct"] and out["readings"]["served_gap"] > 50
        family.write_text(PLANTED_FAMILY.format(shift="0.0"))
        res, out = _run(root, "tiny.planted")
        assert res["correct"] and out["readings"]["served_gap"] <= 1e-3
        after = {p: p.read_bytes() for p in before}
        assert after == before
    finally:
        for p in [*new, family]:
            p.unlink(missing_ok=True)
        (root / "BENCHMARK.json").write_text(spec_before)
