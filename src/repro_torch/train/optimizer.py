"""AdamW + schedules + gradient compression, on nested dicts of tensors.

The JAX package's ``train/optimizer.py`` on PyTorch, with the same float32
arithmetic in the same order:

  * AdamW with decoupled weight decay (on leaves with ``ndim >= 2``: the
    stacked per-layer norms ``[L, D]`` decay, the unstacked final norm does
    not, as in JAX), global-norm clipping, float32 or bfloat16 moments,
    bias correction ``b ** step`` in float32
  * warmup-cosine LR schedule, in float32
  * gradient compression: cast to bf16 ("bf16") or int8 with a
    per-tensor absmax scale and error feedback ("int8", its state in the
    optimizer state); ``torch.round`` rounds half to even, as
    ``jnp.round`` does

Trees are nested dicts whose leaves are visited in the JAX tree's order,
sorted keys, so :func:`global_norm` adds the leaves' squares in the same
order.  :func:`adamw_update` writes the new parameters and moments into
the given tensors in place, under ``torch.no_grad()`` (the port's stand-in
for JAX's buffer donation), and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from ..checkpoint.format import flatten_tree

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    compression: str = "none"     # none | bf16 | int8
    grad_accum: int = 1           # microbatches per step (activation memory)


def leaves(tree) -> Iterator[torch.Tensor]:
    """The tree's leaves in the JAX tree's order (sorted keys), the order
    of :func:`~repro_torch.checkpoint.format.flatten_tree`."""
    return (v for _, v in flatten_tree(tree))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def lr_schedule(cfg: OptimizerConfig
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (an integer tensor) -> the learning rate, a float32 tensor."""
    def fn(step):
        step = step.to(torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
        frac = torch.clip((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        mult = torch.where(step < cfg.warmup_steps, warm,
                           cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)
        return cfg.lr * mult
    return fn


def init_opt_state(params: Params, cfg: OptimizerConfig) -> Dict[str, Any]:
    """Zero moments of ``cfg.moment_dtype`` beside each leaf, the int32
    step (a 0-d tensor) and, for int8 compression, the bfloat16
    error-feedback state."""
    mdt = _DTYPES[cfg.moment_dtype]
    device = next(leaves(params)).device
    state = {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.compression == "int8":
        state["ef"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.bfloat16, device=p.device), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    added one after another in tree order (``jax.tree.reduce``)."""
    total = None
    for g in leaves(tree):
        sq = torch.sum(g.float() ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


# -- gradient compression -------------------------------------------------------


def _int8(g: torch.Tensor, e: torch.Tensor):
    gf = g.float() + e.float()
    scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
    qi = torch.clip(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = qi.float() * scale
    return deq, (gf - deq).to(torch.bfloat16)


def compress_grads(grads, state, cfg: OptimizerConfig):
    """Apply the configured compression *before* the data-parallel reduce.

    bf16: halves all-reduce bytes.  int8: quarters them; per-tensor absmax
    scale with error feedback so the quantization error is re-injected next
    step instead of being lost.  Returns (grads, state); the state is a new
    dict when ``ef`` changes.
    """
    if cfg.compression == "none":
        return grads, state
    if cfg.compression == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), state
    if cfg.compression == "int8":
        pairs = tree_map(_int8, grads, state["ef"])   # (deq, ef) leaves
        state = dict(state, ef=tree_map(lambda q: q[1], pairs))
        return tree_map(lambda q: q[0], pairs), state
    raise ValueError(cfg.compression)


# -- AdamW update -----------------------------------------------------------------


@torch.no_grad()
def adamw_update(grads, state, params, cfg: OptimizerConfig
                 ) -> Tuple[Params, Dict[str, Any]]:
    """One AdamW step.  Writes the new parameters into ``params`` and the
    new moments into ``state["m"]``, ``state["v"]`` in place, and returns
    (params, state) with ``state["step"]`` advanced (a new tensor)."""
    step = state["step"] + 1
    lr = lr_schedule(cfg)(step)
    gn = global_norm(grads)
    clip = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, 1e-9), 1.0)
    stepf = step.to(torch.float32)
    b1, b2 = (torch.tensor(b, dtype=torch.float32, device=step.device)
              for b in (cfg.b1, cfg.b2))
    c1, c2 = 1 - b1 ** stepf, 1 - b2 ** stepf

    def upd(p, g, m, v):
        gf = g.float() * clip
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)

    tree_map(upd, params, grads, state["m"], state["v"])
    new_state = dict(state)
    new_state["step"] = step
    return params, new_state


# -- ZeRO-1 sharding specs --------------------------------------------------------


def zero_specs(param_specs, param_shapes, data_axis: str = "data",
               data_size: int = 1, min_size: int = 2 ** 16):
    """Moment PartitionSpecs: params' TP specs + data-axis sharding on the
    largest still-unsharded, divisible dimension (ZeRO-1).

    Small tensors (< min_size elements) stay replicated — sharding them
    costs more in collective latency than it saves in bytes.
    """
    from ..launch.shardings import PartitionSpec as P, tree_map_specs

    def one(spec, shape):
        dims = tuple(shape.shape if hasattr(shape, "shape") else shape)
        total = 1
        for s in dims:
            total *= s
        if total < min_size:
            return spec
        entries = list(spec) if spec is not None else [None] * len(dims)
        while len(entries) < len(dims):
            entries.append(None)
        # choose the largest unsharded divisible dim
        best, best_size = None, 0
        for i, (e, d) in enumerate(zip(entries, dims)):
            if e is None and d % data_size == 0 and d > best_size:
                best, best_size = i, d
        if best is not None:
            entries[best] = data_axis
        return P(*entries)

    return tree_map_specs(one, param_specs, param_shapes)
