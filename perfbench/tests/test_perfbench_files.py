"""Every cell's files are found by name, and BENCHMARK.json keeps the
benchmark's contract: names, units, bounds, paths and the per-layer
metrics' readers."""
import json
import re
from pathlib import Path

import pytest

import harness as H
import traffic as TR

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_bounds():
    names = []
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    b = H.Bench(ROOT, cell)
    assert b.conf["arch"]
    loop = H.module_at("loops", b.mix["loop"], b.dir)
    assert callable(loop.run) and callable(loop.drive)
    assert loop.COUNT in ("due", "done")
    assert b.limits, "every cell states the limits of its check"
    assert b.cell["chips"] == 1
    assert Path(ROOT / b.config_entry["file"]).is_file()
    e2e = {m["name"] for m in b.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert b.per_layer(), "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_declares_what_benchmark_json_says(metric):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    mod = H.module_at("metrics", metric)
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == \
        (entry["layer"], entry["unit"], entry["moves"])
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for cell in entry["workloads"]:
        assert cell in e2e[entry["moves"]].get("workloads", CELLS)
    assert mod.read({}) is None, "a reader with nothing to read is silent"


def test_every_traffic_and_config_file_is_used():
    used_t = {w["traffic"] for w in SPEC["workloads"]}
    assert used_t == {p.stem for p in (H.HERE / "traffic").glob("*.json")}
    files = {c["file"] for c in SPEC["configs"]}
    assert files == {f"perfbench/configs/{p.name}"
                     for p in (H.HERE / "configs").glob("*.json")}
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert conf["source"].startswith(c["source"])


def test_load_json_names_the_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope"):
        TR.load_json("traffic", "nope", tmp_path)
