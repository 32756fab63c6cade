"""Mixture-of-Experts FFN: top-k routing, shared experts, capacity
dispatch — the JAX package's ``models/moe.py`` on PyTorch.

Tokens are scattered into a per-expert ``[E, C, D]`` buffer (C = capacity)
at positions from a cumulative sum over the routing assignment, the expert
FFNs run as batched products over the stacked expert weights, and the
outputs gather back with the routing weights.  Tokens past capacity are
dropped (GShard/Switch semantics; ``capacity_factor`` sets the slack).

What parity with JAX needs, and where it is kept:

* the capacity is ``int(max(1, round(t * top_k * cf / E)))`` computed on
  the host with Python's ``round`` (halves to even), where ``t`` is the
  step's width, padding included;
* the cumulative sum runs token-major, slot-minor over ``[T * k]`` (per
  batch row under the grouped dispatch, over all ``B * T`` tokens under the
  global one), so the same tokens are dropped;
* ``torch.topk(sorted=True)`` orders the k choices as ``jax.lax.top_k``;
* the router and its logits are float32 whatever the model dtype.

JAX gathers the k weighted expert rows back with a scatter-add over the
token index; here the rows are already token-major, slot-minor, so a sum
over the k slots of ``[..., T, k, D]`` is the same gather, and it is
deterministic on the card, where ``index_add_`` would add the k rows in
the order its atomics land (a route could then flip from one run to the
next).

The expert products stay ``torch.einsum`` over the stacked weights, as the
JAX package leaves them to XLA: there is no TPU kernel here to port.  The
grouped dispatch reads every expert's weights in every step.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ModelConfig
from .sharded import placed_like

Params = Dict[str, Any]


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a dispatch group of ``tokens`` tokens."""
    m = cfg.moe
    return int(max(1, round(tokens * m.top_k * m.capacity_factor
                            / m.num_experts)))


def route(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Router of ``x`` [..., D]: (probs [..., E] f32, weights [..., k]
    renormalised over the top k, expert ids [..., k])."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.moe.top_k, dim=-1, sorted=True)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, weights, idx


def _aux(probs: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig
         ) -> torch.Tensor:
    """Switch-style load-balancing loss over every token of the call."""
    m = cfg.moe
    e = m.num_experts
    density = F.one_hot(idx[..., 0].reshape(-1), e).float().mean(0)
    mean_prob = probs.reshape(-1, e).mean(0)
    return (density * mean_prob).sum() * e * m.router_aux_coef


def _slots(flat_idx: torch.Tensor, e: int, cap: int):
    """Position of each (token, slot) pair within its expert, by a
    cumulative sum along the last axis; (safe position, keep)."""
    onehot = F.one_hot(flat_idx.long(), e)
    pos = ((onehot.cumsum(-2) - onehot) * onehot).sum(-1)
    keep = pos < cap
    return torch.where(keep, pos, torch.zeros_like(pos)), keep


def _experts(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its buffer: [..., E, C, D] ->
    [..., E, C, D]."""
    gate = torch.einsum("...ecd,edf->...ecf", buf, p["w_gate"])
    up = torch.einsum("...ecd,edf->...ecf", buf, p["w_up"])
    return torch.einsum("...ecf,efd->...ecd", F.silu(gate) * up,
                        p["w_down"])


def _shared(p: Params, x: torch.Tensor) -> torch.Tensor:
    sp = p["shared"]
    return (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, D] -> (out [B, T, D], aux loss, a float32 scalar)."""
    if cfg.moe_dispatch == "grouped":
        return moe_ffn_grouped(p, x, cfg)
    return moe_ffn_global(p, x, cfg)


def _dispatch(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Route each batch row's tokens and scatter them into the per-expert
    buffer: (buf [B, E, C, D], the slots' (row, expert, position) index
    and weights, probs, expert ids)."""
    m = cfg.moe
    b, t, d = x.shape
    e, k = m.num_experts, m.top_k
    probs, weights, idx = route({"router": router}, x, cfg)  # [B, T, k]
    cap = capacity(t, cfg)
    flat_idx = idx.reshape(b, t * k)
    safe_pos, keep = _slots(flat_idx, e, cap)                 # [B, T*k]
    flat_w = weights.reshape(b, t * k) * keep.to(weights.dtype)
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    contrib = torch.where(keep[..., None], x[:, tok_idx],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    bidx = torch.arange(b, device=x.device)[:, None].expand_as(flat_idx)
    # each slot takes one kept token; a dropped one adds zero to slot 0
    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((bidx, flat_idx, safe_pos), contrib, accumulate=True)
    return buf, (bidx, flat_idx, safe_pos), flat_w, probs, idx


def _combine(out_buf: torch.Tensor, slots, flat_w: torch.Tensor,
             k: int) -> torch.Tensor:
    """Each token's k expert rows, weighted and summed: [B, T, D]."""
    b, _, _, d = out_buf.shape
    expert_out = out_buf[slots] * flat_w[..., None].to(out_buf.dtype)
    return expert_out.reshape(b, -1, k, d).sum(2)             # [B, T, D]


def moe_ffn_grouped(p: Params, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style grouped dispatch: each batch row is its own dispatch
    group (the cumulative sum runs over that row's T * k slots)."""
    if isinstance(x, DTensor):
        return _grouped_sharded(p, x, cfg)
    buf, slots, flat_w, probs, idx = _dispatch(x, p["router"], cfg)
    out = _combine(_experts(p, buf), slots, flat_w, cfg.moe.top_k)
    if cfg.moe.num_shared:
        out = out + _shared(p, x)
    return out, _aux(probs, idx, cfg)


def _grouped_sharded(p: Params, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouped dispatch on DTensors (the dry run's sharded step): each
    rank routes, scatters and combines whole rows (x gathered along every
    dim but the rows'); the expert products run on the DTensor buffer
    against the sharded expert weights (tensor- or expert-parallel, as the
    specs place them).  The aux loss's two means are sums over the row
    shards, reduced, then divided, so it is the whole batch's."""
    mesh = x.device_mesh
    rows = [q if q == Shard(0) else Replicate() for q in x.placements]
    over_rows = [Partial() if q == Shard(0) else Replicate() for q in rows]
    router = p["router"].redistribute(mesh, [Replicate()] * mesh.ndim) \
        .to_local(grad_placements=over_rows)
    buf, slots, flat_w, probs, idx = _dispatch(
        x.redistribute(mesh, rows).to_local(), router, cfg)
    buf = DTensor.from_local(buf, mesh, rows, run_check=False)
    out_buf = _experts(p, buf).redistribute(mesh, rows).to_local()
    out = DTensor.from_local(_combine(out_buf, slots, flat_w,
                                      cfg.moe.top_k), mesh, rows,
                             run_check=False)
    if cfg.moe.num_shared:
        out = out + _shared(p, x)
    e = cfg.moe.num_experts
    n = x.shape[0] * x.shape[1]
    sums = [DTensor.from_local(s, mesh, over_rows, run_check=False)
            .redistribute(mesh, [Replicate()] * mesh.ndim) / n
            for s in (F.one_hot(idx[..., 0].reshape(-1), e).float().sum(0),
                      probs.reshape(-1, e).sum(0))]
    aux = (sums[0] * sums[1]).sum() * e * cfg.moe.router_aux_coef
    return placed_like(out, x), aux


def moe_ffn_global(p: Params, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global dispatch: one cumulative sum over all B * T tokens, so one
    row's padding can take a later row's slot (the JAX baseline) — the
    grouped dispatch of the batch as one row of B * T tokens."""
    b, t, d = x.shape
    out, aux = moe_ffn_grouped(p, x.reshape(1, b * t, d), cfg)
    return out.reshape(b, t, d), aux
