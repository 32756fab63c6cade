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

The tree is the one ``DecoderLM.init`` builds: the same keys, shapes and
dtypes (the MoE router float32, everything else the model's dtype).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 28     # elements filled by one generator call
RESIDUAL_GAIN = 4.0
ROUTER_GAIN = 8.0

# (path, shape, dtype kind, init) with init one of
# ("dense", d_in) | ("wide", (d_in, gain)) | ("normal", std) | ("scale", 0)
Spec = Tuple[Tuple[str, ...], Tuple[int, ...], str, Tuple[str, float]]


def leaf_specs(cfg) -> List[Spec]:
    """Every leaf of a dense or MoE ``DecoderLM``'s parameter tree."""
    d, n, v = cfg.d_model, cfg.num_layers, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    out: List[Spec] = [(("embed",), (v, d), "model", ("normal", 0.02))]
    if not cfg.tie_embeddings:
        out.append((("lm_head",), (d, v), "model", ("dense", d)))
    lay = ("layers",)
    out += [(lay + ("ln1",), (n, d), "model", ("scale", 0.0)),
            (lay + ("ln2",), (n, d), "model", ("scale", 0.0)),
            (lay + ("attn", "wq"), (n, d, q), "model", ("dense", d)),
            (lay + ("attn", "wk"), (n, d, kv), "model", ("dense", d)),
            (lay + ("attn", "wv"), (n, d, kv), "model", ("dense", d)),
            (lay + ("attn", "wo"), (n, q, d), "model",
             ("wide", (q, RESIDUAL_GAIN)))]
    if cfg.qkv_bias:
        out += [(lay + ("attn", "bq"), (n, q), "model", ("normal", 0.02)),
                (lay + ("attn", "bk"), (n, kv), "model", ("normal", 0.02)),
                (lay + ("attn", "bv"), (n, kv), "model", ("normal", 0.02))]
    if cfg.moe is None:
        f = cfg.d_ff
        out += [(lay + ("mlp", "w_gate"), (n, d, f), "model", ("dense", d)),
                (lay + ("mlp", "w_up"), (n, d, f), "model", ("dense", d)),
                (lay + ("mlp", "w_down"), (n, f, d), "model",
                 ("wide", (f, RESIDUAL_GAIN)))]
    else:
        m = cfg.moe
        e, fe = m.num_experts, m.d_expert
        moe = lay + ("moe",)
        out += [(moe + ("router",), (n, d, e), "float32",
                 ("wide", (d, ROUTER_GAIN))),
                (moe + ("w_gate",), (n, e, d, fe), "model", ("dense", d)),
                (moe + ("w_up",), (n, e, d, fe), "model", ("dense", d)),
                (moe + ("w_down",), (n, e, fe, d), "model",
                 ("wide", (fe, RESIDUAL_GAIN)))]
        if m.num_shared:
            fs = fe * m.num_shared
            sh = moe + ("shared",)
            out += [(sh + ("w_gate",), (n, d, fs), "model", ("dense", d)),
                    (sh + ("w_up",), (n, d, fs), "model", ("dense", d)),
                    (sh + ("w_down",), (n, fs, d), "model",
                     ("wide", (fs, RESIDUAL_GAIN)))]
    out.append((("final_norm",), (d,), "model", ("scale", 0.0)))
    return out


def _numel(shape) -> int:
    k = 1
    for s in shape:
        k *= s
    return k


def make(cfg, seed: int, device, model_dtype: torch.dtype) -> Dict:
    """The parameter tree for ``cfg`` from ``seed`` on ``device``."""
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

