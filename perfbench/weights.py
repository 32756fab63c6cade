"""Weights made from the seed, on the device, in the port's layout.

The benchmark hands the same weights to the program (``Engine(params=)``)
and, made again after the program's state is freed, to the plain
reference.  Every leaf of one dtype is a view into one flat
buffer that a ``torch.Generator`` on the device fills with standard
normals in fixed-size calls; each view is then scaled in place:

* matrices ``N(0, 1 / d_in)``, the embedding ``N(0, 0.02^2)``;
* the matrices that write into the residual stream (``wo``, ``w_down``,
  the shared experts' ``w_down``) ``RESIDUAL_GAIN`` times wider, and the
  MoE router ``ROUTER_GAIN`` times wider;
* norm scales ``1 + N(0, 0.02^2)`` and QKV biases ``N(0, 0.02^2)``, so
  that a path which drops a scale or a bias shows in the comparison.

The two gains keep the served tokens sensitive to the precision of the
arithmetic, as a trained model's are, so that the correctness check can
tell bfloat16 from the float8 control.  At plain ``N(0, 1 / d_in)`` the
tied qwen2-1.5b repeats its input token at 98% of positions, by a median
top-2 margin of 1.77 logits that no rounding moves, and a router of
``N(0, 1 / d)`` picks its top 4 of 60 experts by near-ties.

Which leaves there are, with their shapes, dtypes and inits, is the
model family's ``leaf_specs`` (:func:`harness.family`): the tree the
port's own ``init`` builds, the same keys, shapes and dtypes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

import harness as H

CHUNK = 1 << 28     # elements filled by one generator call
RESIDUAL_GAIN = 4.0
ROUTER_GAIN = 8.0

# (path, shape, dtype kind, init) with init one of
# ("dense", d_in) | ("wide", (d_in, gain)) | ("normal", std) | ("scale", 0)
Spec = Tuple[Tuple[str, ...], Tuple[int, ...], str, Tuple[str, float]]


def leaf_specs(cfg) -> List[Spec]:
    """Every leaf of a dense or MoE Qwen2 ``DecoderLM``'s parameter tree
    (:mod:`families.qwen2`)."""
    return H.module_at("families", "qwen2").leaf_specs(cfg)


def _numel(shape) -> int:
    k = 1
    for s in shape:
        k *= s
    return k


def make(cfg, seed: int, device, model_dtype: torch.dtype,
         specs: Optional[List[Spec]] = None) -> Dict:
    """The parameter tree for ``cfg`` from ``seed`` on ``device``: the
    leaves ``specs`` names, its family's ``leaf_specs(cfg)`` (by default
    the Qwen2 decoder's)."""
    if specs is None:
        specs = leaf_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    dtypes = {"model": model_dtype, "float32": torch.float32}
    bufs = {}
    for kind in ("model", "float32"):
        total = sum(_numel(s) for _, s, k, _ in specs if k == kind)
        if not total:
            continue
        buf = torch.empty(total, dtype=dtypes[kind], device=device)
        for lo in range(0, total, CHUNK):
            buf[lo:lo + CHUNK].normal_(generator=gen)
        bufs[kind] = buf
    tree: Dict = {}
    offsets = {k: 0 for k in bufs}
    for path, shape, kind, (init, arg) in specs:
        lo = offsets[kind]
        offsets[kind] = lo + _numel(shape)
        leaf = bufs[kind][lo:offsets[kind]].view(shape)
        if init == "dense":
            leaf.mul_(arg ** -0.5)
        elif init == "wide":
            leaf.mul_(arg[1] * arg[0] ** -0.5)
        elif init == "normal":
            leaf.mul_(arg)
        else:
            leaf.mul_(0.02).add_(1.0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree

