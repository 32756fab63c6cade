"""What every cell shares: finding its files, choosing its metrics,
reading the per-layer metric files, the device line and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model configuration as it is run;
* ``families/<model_type>.py``: the module of the configuration's model
  family, by its Hugging Face ``model_type`` (:func:`family`);
* ``traffic/<mix>.json``: the mix's parameters, read by
  :mod:`traffic`; its ``"loop"`` names the module ``loops/<loop>.py``
  that runs the cell (``run``) and drives its load (``drive``);
* ``metrics/<metric>.py``: one per-layer metric, a module with ``LAYER``,
  ``UNIT``, ``MOVES`` and ``read(rec)``, which returns a number or None
  when the run holds nothing for it to read;
* ``limits/<workload>.json``: each number the cell's correctness check
  compares, with its limit and the readings the limit was set from.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Bench:
    """``BENCHMARK.json`` and the files of one of its cells."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.name = workload
        self.dir = self.root / "perfbench"
        confs = {c["name"]: c for c in self.spec["configs"]}
        self.config_entry = confs[self.cell["config"]]
        self.conf = json.loads((self.root / self.config_entry["file"])
                               .read_text())
        self.mix = load_data(self.dir / "traffic" /
                             f"{self.cell['traffic']}.json")
        lim = self.dir / "limits" / f"{workload}.json"
        self.limits = load_data(lim) if lim.is_file() else {}

    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        mine = {m["name"] for m in self.end_to_end()}
        out = []
        for m in self.spec["per_layer"]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif m["moves"] in mine:
                out.append(m)
        return out


def load_data(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"missing {path}")
    return json.loads(path.read_text())


def module_at(kind: str, name: str, root: Path = HERE):
    """``<root>/<kind>/<name>.py`` loaded by path (names hold dots):
    a metric's reader, a traffic loop or a model family."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {path} for {kind} {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(conf: dict, root: Path = HERE):
    """The model family of a configuration file, ``families/<model_type>.py``:
    everything the harness does that depends on the model.  It defines
    ``port_config(conf)``, the port's ``ModelConfig``; ``leaf_specs(cfg)``,
    the leaves :func:`weights.make` fills; ``readings(params, conf, server,
    sample, *, control, device)``, the numbers the cell's limits judge,
    worked out by the family's own plain reference; and ``counts(conf)``,
    the operations and bytes :mod:`roofline` divides by."""
    return module_at("families", conf["model_type"], root)


def read_per_layer(entries: List[dict], rec: dict,
                   root: Path = HERE) -> Dict[str, dict]:
    """Each metric's reader over the traced run's records; a reader that
    finds nothing leaves its metric out."""
    out = {}
    for m in entries:
        v = module_at("metrics", m["name"], root).read(rec)
        if v is not None:
            if not math.isfinite(v):
                raise ValueError(f"metric {m['name']} read {v}")
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared by whole names (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_line(dev, chips: int, peak: int) -> dict:
    """The result line's ``device``; a CPU run (the tests') says so."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": int(peak)}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(peak)}


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def find_src(root: Path) -> Optional[Path]:
    src = Path(root) / "src"
    return src if (src / "repro_torch").is_dir() else None
