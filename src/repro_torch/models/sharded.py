"""The model's DTensor steps: what a step whose tensors are placed on a
device mesh needs beyond the plain model.

DTensors reach the model through the dry run's sharded step
(``launch/cells.py``) and through params placed by
``launch.shardings.distribute``.  DTensor places each op's output
greedily and refuses views that GSPMD reshards silently, so these steps
place what GSPMD chooses itself; each says which collective it adds.
The functions that take a plain tensor are no-ops on it (or the plain op
they stand for); :func:`on_shards`, :func:`vocab_parallel_nll` and
:func:`positions_like` take DTensors only.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

Params = Dict[str, Any]


def on_shards(fn, xs, keep: Sequence[int], out_dims: Sequence[dict],
              extra=None):
    """``fn`` of DTensors, run on each rank's shard by ``local_map``: a
    scan or an attention is independent across batch rows and heads or
    channels (and DTensor cannot batch a product over two sharded dims).
    Each input is placed as the first with only the dims in ``keep``
    sharded, ``extra`` (a tensor and a map from the first input's dims to
    its own) follows, and each output is placed as its dims map to
    (``out_dims``).  ``extra``'s gradient is a partial sum over each mesh
    dim that splits the first input along a dim ``extra`` lacks (each
    rank's rows add their share)."""
    pl = [p if isinstance(p, Shard) and p.dim in keep else Replicate()
          for p in xs[0].placements]
    ins, args = [tuple(pl)] * len(xs), list(xs)
    grads = list(ins)
    if extra is not None:
        t, dims = extra
        ins.append(tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                         else Replicate() for p in pl))
        grads.append(tuple(Partial() if p.is_shard() and p.dim not in dims
                           else q for p, q in zip(pl, ins[-1])))
        args.append(t)
    outs = tuple(tuple(Shard(m[p.dim]) if p.is_shard() else p for p in pl)
                 for m in out_dims)
    return local_map(lambda *a: tuple(fn(*a)), out_placements=outs,
                     in_placements=tuple(ins),
                     in_grad_placements=tuple(grads),
                     device_mesh=xs[0].device_mesh,
                     redistribute_inputs=True)(*args)


def row_major(t: DTensor) -> DTensor:
    """``t`` with the row-major strides of its shape.  DTensor propagates
    strides through views and broadcasts, and a size-1 dim can come out
    with any stride; a ``[B, 1, D]`` operand that looks so to
    ``torch.matmul`` is not folded into one matrix product but run as a
    batched one over a copy of the weight for every row.  Flattening and
    restoring the shape is a view where the layout allows one."""
    return t.reshape(-1, t.shape[-1]).view(t.shape)


def even_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` [B, T, n * hd] with its ``n`` heads splittable on every rank.

    A column-parallel projection shards its features over the model axis,
    and when the heads do not divide that axis DTensor refuses the head
    split, where GSPMD reshards silently.  Each such mesh dim moves its
    shard to the batch (dim 0, an all-to-all) when the batch divides,
    else replicates (an all-gather)."""
    if not isinstance(t, DTensor):
        return t
    mesh, dim = t.device_mesh, t.dim() - 1
    pl = list(t.placements)
    for i, p in enumerate(pl):
        if p == Shard(dim) and n % mesh.size(i):
            split = mesh.size(i)
            for j, q in enumerate(pl):
                if q == Shard(0):
                    split *= mesh.size(j)
            pl[i] = Shard(0) if t.shape[0] % split == 0 else Replicate()
    return t.redistribute(mesh, pl)


def like_columns(o: torch.Tensor, x: torch.Tensor, w: torch.Tensor
                 ) -> torch.Tensor:
    """``o`` [B, T, H * hd], the merged heads, placed as the
    column-parallel ``x @ w`` placed its features (undoing
    :func:`even_heads`), so the output projection stays Megatron's
    row-parallel product."""
    if not isinstance(o, DTensor):
        return o
    col = Shard(w.dim() - 1)
    pl = [Shard(2) if wp == col else xp
          for xp, wp in zip(x.placements, w.placements)]
    return row_major(o.redistribute(o.device_mesh, pl))


def placed_like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` placed as ``x``: a sublayer's output placed as the residual
    stream it adds to.

    Left alone the stream drifts (a row-parallel product's partial sum,
    features or batch split over the model axis).  Megatron's layout is
    the batch's: batch-sharded over the data axes, replicated over
    "model", so a partial sum is all-reduced here, as GSPMD inserts it.
    Its gradient goes back placed as ``y`` was, a partial sum's
    replicated (the all-reduce of Megatron's backward), even where the
    forward moved nothing."""
    if not isinstance(y, DTensor):
        return y
    return _Place.apply(y, tuple(x.placements))


class _Place(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, whose gradient is
    replicated on every mesh dim where the input was a partial sum: each
    rank's addend gets the sum's whole gradient, reduced here once per
    sublayer (Megatron's all-reduce of the stream's gradient), where
    ``redistribute`` would hand back a partial sum and leave DTensor to
    reduce it later inside the sublayer, over wider tensors."""

    @staticmethod
    def forward(ctx, y, placements):
        ctx.src = y.placements
        return row_major(y.redistribute(y.device_mesh, placements))

    @staticmethod
    def backward(ctx, g):
        pl = [Replicate() if s.is_partial() else s for s in ctx.src]
        return g.redistribute(g.device_mesh, pl), None


def write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """``cache[:, :, slot] = new[:, :, 0]``, in place.

    A DTensor cache split along the sequence (where the heads do not
    divide the model axis): each rank writes the slot only if its shard
    holds it, as GSPMD partitions a dynamic-update-slice; indexing the
    sharded dim would gather the whole cache into a copy."""
    if not (isinstance(cache, DTensor) and Shard(2) in cache.placements):
        cache[:, :, slot] = new[:, :, 0]
        return
    mesh, pl = cache.device_mesh, cache.placements
    (i,) = [j for j, q in enumerate(pl) if q == Shard(2)]
    new = new.redistribute(mesh, [Replicate() if q == Shard(2) else q
                                  for q in pl]).to_local()
    local = cache.to_local()
    lo = mesh.get_coordinate()[i] * -(-cache.shape[2] // mesh.size(i))
    if lo <= slot < lo + local.shape[2]:
        local[:, :, slot - lo] = new[:, :, 0]


def pad_slots(k: torch.Tensor, v: torch.Tensor, pad: int):
    """k, v [B, H, S, hd] with ``pad`` zero slots added along S.  On
    DTensors the pad runs on each rank's shard: on a 2-D mesh torch
    2.11's DTensor gives a padded tensor the placements of one mesh dim
    only."""
    def fn(k, v):
        return F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))

    if isinstance(k, DTensor):
        heads = {0: 0, 1: 1}
        return on_shards(fn, (k, v), (0, 1), (heads, heads))
    return fn(k, v)


def vocab_parallel_nll(lf: DTensor, idx: torch.Tensor,
                       labels: torch.Tensor):
    """(log-sum-exp, the label's logit) of vocab-sharded float32 logits
    ``lf`` [..., V] at ``idx`` [..., 1]: the log-sum-exp from a max and a
    sum over the vocab shards, and the label's logit by a compare and a
    sum (DTensor cannot reduce the masked partial result of a gather
    along a sharded dim), each a partial result reduced over [B, T],
    never the logits gathered."""
    m = placed_like(lf.detach().amax(-1, keepdim=True), idx)
    total = placed_like(torch.exp(lf - m).sum(-1), labels)
    lse = torch.log(total) + m[..., 0]
    mesh, vdim = lf.device_mesh, Shard(lf.dim() - 1)
    vocab = DTensor.from_local(
        torch.arange(lf.shape[-1], device=lf.device), mesh,
        [Replicate()] * mesh.ndim, run_check=False).redistribute(
            mesh, [Shard(0) if q == vdim else Replicate()
                   for q in lf.placements])
    picked = placed_like(
        torch.where(vocab == idx, lf, torch.zeros_like(lf)).sum(-1), labels)
    return lse, picked


def gather_layer(layer_p: Params) -> Params:
    """FSDP's per-layer gather: one layer's slice of the stacked params
    replicated before the layer runs, one layer's all-gather per step of
    the loop, as JAX constrains its scan's slice."""
    return {k: gather_layer(v) if isinstance(v, dict)
            else v.redistribute(v.device_mesh,
                                [Replicate()] * v.device_mesh.ndim)
            if isinstance(v, DTensor) else v
            for k, v in layer_p.items()}


def positions_like(tokens: DTensor) -> DTensor:
    """Positions [B, T] placed as the tokens are, so the RoPE tables are
    computed for each rank's rows only."""
    t = tokens.shape[1]
    local = tokens.to_local()
    pos = torch.arange(t, device=local.device).expand(local.shape[0], t)
    return DTensor.from_local(pos, tokens.device_mesh, tokens.placements,
                              run_check=False)
