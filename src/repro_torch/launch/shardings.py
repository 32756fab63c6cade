"""Partitioning rules: DP / TP / EP / SP specs for every architecture family.

The JAX package's ``launch/shardings.py``, rule for rule, over the port's
nested-dict trees (walked by path name, as JAX walks its pytrees).
Megatron-style tensor parallelism over the "model" axis:
  * column-parallel (shard output features): wq/wk/wv, w_gate/w_up, ...
  * row-parallel  (shard input features):   wo, w_down, ...
  * vocab-parallel embedding / LM head
  * MoE experts: TP *within* experts by default (always divisible);
    expert-parallel (shard E over "model") available when E % model == 0
    — selectable via ``expert_parallel=True``
  * ZeRO-1: optimizer moments additionally sharded over the data axis

Batch (and pod) axes carry pure data parallelism.  KV caches shard over
batch when divisible, else over the sequence axis (memory scaling for
serving shapes).

A spec is a :class:`PartitionSpec`: one entry per tensor dimension, each
None, a mesh axis name or a tuple of them.  :func:`named` turns specs
into DTensor placements on a ``DeviceMesh`` and :func:`distribute` puts a
tree of tensors onto it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..configs.base import ModelConfig, ShapeConfig
from .mesh import axis_size, dp_axes, dp_size

# weight-name classes (matched on the trailing key of the leaf's path)
_COL_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "wck", "wcr", "wg",
                 "wr", "w_i", "w_r", "w_rec"}
_ROW_PARALLEL = {"wo", "w_down", "wcv", "w_out"}
_COL_BIAS = {"bq", "bk", "bv", "b_i", "b_r", "conv_b"}
_REPLICATED = {"ln1", "ln2", "ln_x", "final_norm", "enc_norm", "ln1_s",
               "ln1_b", "ln2_s", "ln2_b", "gn_s", "gn_b", "mu", "mu_x",
               "mu_ck", "mu_cr", "w0", "u", "router", "lora_A", "lora_B",
               "wdecay_A", "wdecay_B", "step"}


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: ``PartitionSpec(None, "model")`` is the
    tuple ``(None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec resolved on a mesh: one placement per mesh dimension."""
    mesh: Any
    placements: Tuple[Placement, ...]


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _map_with_path(fn: Callable, tree, *rest, path=(), is_leaf=None):
    """``fn(names, leaf, *rest_leaves)`` over a nested dict, keeping its
    structure; ``names`` is the leaf's path of keys."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest),
                                  path=path + (str(k),), is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def tree_map_specs(fn: Callable, spec_tree, *rest):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    return _map_with_path(lambda _, s, *r: fn(s, *r), spec_tree, *rest,
                          is_leaf=_is_spec)


def _leaf_spec(cfg: ModelConfig, names: Tuple[str, ...], shape,
               model_axis: str, *, expert_parallel: bool,
               model_size: int) -> P:
    name = names[-1] if names else ""
    ndim = len(shape)
    none = (None,) * ndim

    def shard_dim(d: int) -> P:
        if shape[d] % model_size != 0:
            # GSPMD pads uneven shards, but we only *request* clean ones
            return P(*none)
        entries = list(none)
        entries[d] = model_axis
        return P(*entries)

    if name in _REPLICATED or ndim == 0:
        return P(*none)
    if name == "embed":
        return shard_dim(ndim - 2) if ndim >= 2 else P(*none)
    if name == "lm_head":
        return shard_dim(ndim - 1)
    in_moe = "moe" in names and "shared" not in names
    if in_moe and name in ("w_gate", "w_up", "w_down"):
        m = cfg.moe
        e_dim = ndim - 3  # [.., E, D, F] / [.., E, F, D]
        if expert_parallel and m is not None \
                and m.num_experts % model_size == 0:
            return shard_dim(e_dim)
        if name in ("w_gate", "w_up"):
            return shard_dim(ndim - 1)
        return shard_dim(ndim - 2)
    if name in _COL_PARALLEL:
        return shard_dim(ndim - 1)
    if name in _ROW_PARALLEL:
        return shard_dim(ndim - 2)
    if name in _COL_BIAS or name == "lam":
        return shard_dim(ndim - 1)
    if name == "conv":
        return shard_dim(ndim - 1)
    return P(*none)


def param_specs(cfg: ModelConfig, params_shape: Any, mesh, *,
                expert_parallel: bool = False,
                mode: str = "tp") -> Any:
    """PartitionSpec tree matching a params (shape) tree.

    mode="tp": Megatron tensor parallelism over the "model" axis (baseline).
    mode="fsdp": shard the leading (layer-stack / vocab) dimension over
    "model" instead — with ``cfg.fsdp_per_layer_gather`` the model gathers
    one layer's parameters at a time.  Collective bytes scale with
    PARAMETER size instead of ACTIVATION size.
    """
    model_size = axis_size(mesh, "model")

    def one(names, leaf):
        if mode == "fsdp":
            return _fsdp_spec(names, leaf.shape, model_size)
        return _leaf_spec(cfg, names, leaf.shape, "model",
                          expert_parallel=expert_parallel,
                          model_size=model_size)

    return _map_with_path(one, params_shape)


def _fsdp_spec(names: Tuple[str, ...], shape, model_size: int) -> P:
    ndim = len(shape)
    if ndim == 0 or names and names[-1] == "step":
        return P()
    total = 1
    for s in shape:
        total *= s
    if total < 2 ** 12:       # tiny leaves: replication is cheaper
        return P(*([None] * ndim))
    # shard the largest divisible dim, preferring dim 0 (the layer stack)
    for d in list(range(ndim)):
        if shape[d] % model_size == 0:
            entries = [None] * ndim
            entries[d] = "model"
            return P(*entries)
    return P(*([None] * ndim))


def zero_specs(param_spec_tree: Any, params_shape: Any, mesh, *,
               min_size: int = 2 ** 16) -> Any:
    """ZeRO-1 moment specs: add the data axis on the largest free dim."""
    data = dp_axes(mesh)
    dsize = dp_size(mesh)
    if dsize <= 1 or not data:
        return param_spec_tree

    def one(spec, leaf):
        shape = tuple(leaf.shape)
        total = 1
        for s in shape:
            total *= s
        if total < min_size:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        best, best_size = None, 0
        for i, (e, d) in enumerate(zip(entries, shape)):
            if e is None and d % dsize == 0 and d > best_size:
                best, best_size = i, d
        if best is not None:
            entries[best] = data if len(data) > 1 else data[0]
        return P(*entries)

    return tree_map_specs(one, param_spec_tree, params_shape)


def opt_state_specs(cfg: ModelConfig, pspecs: Any, params_shape: Any, mesh,
                    *, zero: bool = True) -> Any:
    mom = zero_specs(pspecs, params_shape, mesh) if zero else pspecs
    return {"m": mom, "v": mom, "step": P()}


# -- activations / batches ----------------------------------------------------------


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                mode: str = "tp") -> Any:
    """Input specs for a given (arch, shape) cell.

    mode="fsdp": the batch shards over data AND model axes (pure DP over
    all ranks); parameters are gathered per layer instead.
    """
    dp = dp_axes(mesh)
    if mode == "fsdp":
        full = dp + ("model",)
        total = dp_size(mesh) * axis_size(mesh, "model")
        if shape.global_batch % total == 0:
            dp, dp_total = full, total
        else:
            dp_total = dp_size(mesh)
    else:
        dp_total = dp_size(mesh)
    dpn = dp if len(dp) > 1 else (dp[0] if dp else None)
    b = shape.global_batch
    bspec = dpn if (dpn is not None and b % dp_total == 0) else None
    tok = P(bspec, None)
    out = {}
    if cfg.input_kind == "embeddings":
        out["embeds"] = P(bspec, None, None)
        out["positions"] = P(None, bspec, None)
    elif cfg.input_kind == "frames":
        out["frames"] = P(bspec, None, None)
        out["tokens"] = tok
    else:
        out["tokens"] = tok
    if shape.kind == "train":
        out["labels"] = tok
    return out


def cache_specs(cfg: ModelConfig, cache_shape: Any, mesh) -> Any:
    """KV-cache / state sharding: batch over data when divisible; the
    sequence axis of attention caches over "model" otherwise (SP)."""
    dp = dp_axes(mesh)
    dpn = dp if len(dp) > 1 else (dp[0] if dp else None)
    dsize = dp_size(mesh)
    msize = axis_size(mesh, "model")

    def one(names, leaf):
        shape = tuple(leaf.shape)
        entries = [None] * len(shape)
        name = names[-1] if names else ""
        # layer-stacked leaves have a leading L/n_super dim
        batch_dim = 1 if len(shape) >= 2 else 0
        if name in ("k", "v") and len(shape) >= 4:
            # [L, B, H, S, hd] or [B, H, S, hd]
            bd = len(shape) - 4
            if shape[bd] % dsize == 0 and dpn is not None:
                entries[bd] = dpn
            hd_ = len(shape) - 3
            sd = len(shape) - 2
            if shape[hd_] % msize == 0:
                entries[hd_] = "model"
            elif shape[sd] % msize == 0:
                entries[sd] = "model"
            return P(*entries)
        if name == "memory":
            if shape[0] % dsize == 0 and dpn is not None:
                entries[0] = dpn
            return P(*entries)
        # recurrent states: [L, B, ...] shard batch; channels over model
        if len(shape) >= 2 and shape[batch_dim] % dsize == 0 \
                and dpn is not None:
            entries[batch_dim] = dpn
        if len(shape) >= 3 and shape[-1] % msize == 0:
            entries[-1] = "model"
        return P(*entries)

    return _map_with_path(one, cache_shape)


# -- specs on a DeviceMesh ------------------------------------------------------------


def placements(mesh, spec: P) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that entry d names, ``Replicate()`` elsewhere.  An
    entry naming several axes (``("pod", "data")``) shards dim d over each
    of them, in mesh order, as JAX splits a dimension major to minor."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    """Specs -> :class:`NamedSharding` leaves on ``mesh``."""
    return tree_map_specs(lambda s: NamedSharding(mesh, placements(mesh, s)),
                          spec_tree)


def local_shape(shape, mesh, placements_: Tuple[Placement, ...]
                ) -> Tuple[int, ...]:
    """The shape of rank 0's shard (the largest: ``torch.chunk`` gives
    the first chunk the rounded-up size)."""
    out = list(shape)
    for i, p in enumerate(placements_):
        if isinstance(p, Shard):
            n = tuple(mesh.shape)[i]
            out[p.dim] = -(-out[p.dim] // n)
    return tuple(out)


def distribute(tree, mesh, spec_tree):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` placed by its spec
    (every rank holds the whole tensor and keeps its shard)."""
    def one(spec, t):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placements(mesh, spec))
        return distribute_tensor(t, mesh, placements(mesh, spec))

    return tree_map_specs(one, spec_tree, tree)
