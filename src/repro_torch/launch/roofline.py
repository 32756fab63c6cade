"""Three-term roofline from a traced dry-run step.

    compute term    = FLOPs      / (chips x peak_FLOP/s)
    memory term     = HBM bytes  / (chips x HBM_bw)
    collective term = coll_bytes / (chips x link_bw)

:class:`~repro_torch.utils.op_count.OpCounter` counts per device (ops on
local shards), so each term is per_device / per_card_rate — the same
number the all-cards formula gives.  The JAX package's
``launch/roofline.py`` with the card's constants.

Hardware constants: NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit, from
NVIDIA's H100 Tensor Core GPU datasheet (dense rates, no sparsity):
    989.4 TFLOP/s bf16 per card; 3.35 TB/s HBM3;
    50 GB/s a card across nodes: one 400 Gb/s NDR InfiniBand port per GPU.
Both production meshes put the 16-wide "model" axis across two 8-GPU
NVLink domains, so every model-axis collective crosses the node boundary
and the inter-node link sets its pace; the data and pod axes span nodes
too.  NVLink 4 gives 450 GB/s a direction per GPU, which only groups of
at most 8 GPUs inside one node would see — no group of either mesh.
"""
from __future__ import annotations

from typing import Any, Dict

from ..configs.base import SHAPES, get_config

PEAK_FLOPS = 989.4e12      # bf16 dense / card
HBM_BW = 3.35e12           # bytes / s / card
LINK_BW = 50e9             # bytes / s / card, inter-node (400 Gb/s NDR)

_NO_XLA = ("xla_cost_flops", "xla_cost_bytes", "hlo_text_bytes",
           "generated_code_size_in_bytes")


def analyze_traced(traced, *, trip_count: int = 1) -> Dict[str, Any]:
    """Every roofline input of one traced cell, under the keys the JAX
    package's ``analyze_lowered`` fills.

    ``traced``: a :class:`~repro_torch.launch.cells.Traced`.
    ``compile_s`` is the seconds of the traced step; the keys that read
    XLA's own analyses (cost analysis, HLO text, generated code) are
    null.  ``argument_size_in_bytes`` is exact, from the local shard
    shapes of the step's inputs; ``temp_size_in_bytes`` is the peak of
    live bytes of the storages the step created
    (:class:`~repro_torch.utils.op_count.OpCounter`).
    """
    c = traced.counter
    a = c.summary()
    out: Dict[str, Any] = {k: None for k in _NO_XLA}
    out["compile_s"] = round(traced.seconds, 2)
    out["argument_size_in_bytes"] = int(traced.argument_bytes)
    out["output_size_in_bytes"] = int(traced.output_bytes)
    out["alias_size_in_bytes"] = int(traced.alias_bytes)
    out["temp_size_in_bytes"] = int(c.peak_bytes)
    out["flops_per_device"] = float(a["flops"])
    out["bytes_per_device"] = float(a["bytes_hbm"])
    out["copy_bytes_per_device"] = float(a["copy_bytes"])
    out["score_bytes_per_device"] = float(a["score_bytes"])
    out["collective_bytes"] = {k: float(v)
                               for k, v in a["collective_bytes"].items()}
    out["collective_counts"] = a["collective_counts"]
    out["trip_count"] = trip_count
    return out


def roofline_terms(record: Dict[str, Any], *, model_flops: float = 0.0,
                   chips: int = 256) -> Dict[str, Any]:
    """The three terms in seconds + dominant bottleneck + usefulness ratio."""
    flops_dev = record.get("flops_per_device", 0.0)
    bytes_dev = record.get("bytes_per_device", 0.0)
    coll_dev = record.get("collective_bytes", {}).get("total", 0.0)
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    # kernel-adjusted memory: flash attention keeps score-shaped tensors
    # on chip (the port's flash kernel, csrc/flash_attention.cu)
    score_dev = record.get("score_bytes_per_device", 0.0)
    t_memory_flash = (bytes_dev - score_dev) / HBM_BW
    total_flops = flops_dev * chips
    out = dict(terms)
    out["memory_flash_s"] = t_memory_flash
    out["dominant"] = dominant.replace("_s", "")
    out["model_flops"] = model_flops
    out["hlo_flops_total"] = total_flops
    out["useful_ratio"] = (model_flops / total_flops) if total_flops else 0.0
    bound = max(t_compute, t_memory, t_coll)
    out["roofline_fraction"] = (t_compute / bound) if bound else 0.0
    out["step_time_lower_bound_s"] = bound
    return out


def model_flops_for(arch: str, shape_name: str) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); decode D=batch
    tokens; prefill/train D=batch*seq; backward adds 2x for training."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
