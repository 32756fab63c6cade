"""Per-device op accounting of a traced step: FLOPs, HBM bytes, collective
bytes per kind — the port's counterpart of the JAX package's
``repro/utils/hlo.py``.

There is no HLO in PyTorch.  :class:`OpCounter` is a ``TorchDispatchMode``
that sees every op the step dispatches on *local shards*: for an op on
DTensors it declines (returns ``NotImplemented``), DTensor runs its
sharding propagation and dispatches the local op, the collectives that
redistribute its inputs, and the local op itself, and those come back
through the mode.  So every number is per device, as hlo.py's are after
SPMD partitioning.  (``FlopCounterMode`` above DTensor counts the
global step.)  The fake ops DTensor runs at global shapes to propagate
output shapes are not counted.

Accounting rules, hlo.py's where they carry over:
  * FLOPs: every matrix product = 2 * M * N * K (``mm``, ``addmm``,
    ``bmm``, ``baddbmm``, ``mv``, ``dot``); ``convolution`` as
    2 * prod(result) * prod(kernel) / kernel output features, and its
    backward as that for each gradient it computes.  Elementwise FLOPs
    are ignored (dots dominate transformer compute).
  * HBM bytes: operands + results of every dispatched op.  In eager mode
    every op is a kernel, so this is hlo.py's rule at fusion
    granularity with every op its own fusion.  Views move no bytes and
    are not counted.
  * Collectives: payload bytes (the larger of operand and result) and
    counts per kind, under hlo.py's ``COLLECTIVE_KINDS`` names.
  * Score bytes: the part of each op's traffic in tensors shaped like
    attention scores (trailing dims ``(q, kv)``, ``q`` one of the
    candidates in ``score_dims[1:]``, ``kv = score_dims[0]``).
  * Loops: the port's layers loop in Python and every iteration
    dispatches its ops, so nothing is multiplied by the layers' trip
    count.  A recurrence's time loop is the exception:
    :func:`repeated` lets the dry run trace one step and count it, and
    its backward, T times (hlo.py's rule for a while body).
  * Live bytes: every storage an op creates counts from its creation to
    the death of the last tensor on it; ``peak_bytes`` is the peak of
    their sum (storages of the step's arguments excluded).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "wait_tensor", "_local_scalar_dense",
               "_unsafe_view", "lift_fresh"}
_COPIES = {"clone", "copy_", "copy"}


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _dims(t) -> Tuple[int, ...]:
    return tuple(t.shape)


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


def dot_flops(name: str, args, out) -> float:
    """2 * M * N * K of one matrix-product op (0 for any other op)."""
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
        return 2.0 * _prod(_dims(a)) * _dims(b)[-1]
    if name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
        return 2.0 * _prod(_dims(a)) * _dims(b)[-1]
    if name == "mv":
        return 2.0 * _prod(_dims(args[0]))
    if name == "dot":
        return 2.0 * _dims(args[0])[0]
    if name == "convolution":
        w = _dims(args[1])
        return 2.0 * out.numel() * _prod(w) / max(w[0], 1)
    if name == "convolution_backward":
        w = _dims(args[2])
        fwd = 2.0 * _prod(_dims(args[0])) * _prod(w) / max(w[0], 1)
        mask = args[-1]
        return fwd * sum(1 for m in mask[:2] if m)
    return 0.0


class OpCounter(TorchDispatchMode):
    """Per-device counts of every op dispatched while the mode is on.

    ``score_dims=(kv_len, q_candidates...)`` also tallies score-shaped
    traffic.  ``arguments``: the step's inputs (plain or DTensor), whose
    storages never count as live temporaries.
    """

    def __init__(self, *, score_dims: Optional[Tuple[int, ...]] = None,
                 arguments=()):
        super().__init__()
        self.score_dims = score_dims
        self.flops = 0.0
        self.bytes_hbm = 0.0
        self.copy_bytes = 0.0
        self.score_bytes = 0.0
        self.collective_bytes: Dict[str, float] = {
            k: 0.0 for k in COLLECTIVE_KINDS}
        self.collective_counts: Dict[str, int] = {
            k: 0 for k in COLLECTIVE_KINDS}
        self._excluded = {_storage_key(_local(t))
                          for t in _tensors(arguments)}
        self._refs: Dict[int, int] = {}
        self._sizes: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._paused = 0
        self._mult = 1
        self._unpatch = None

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        self._unpatch = _patch_dtensor(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count every op inside ``n`` times."""
        self._mult *= n
        try:
            yield
        finally:
            self._mult //= n

    def _set_mult(self, n: int) -> None:
        self._mult = n

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor desugar into local ops and collectives, which
            # come back through this mode
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    # -- accounting ----------------------------------------------------------
    def _count(self, func, args, kwargs, out) -> None:
        name = func.__name__.split(".")[0]
        outs = list(_tensors(out))
        collective = func.namespace == "_c10d_functional"
        kind = _COLLECTIVES.get(name) if collective else None
        if collective and kind is None and name not in _NO_TRAFFIC:
            raise NotImplementedError(f"collective {func} has no kind")
        self.flops += dot_flops(name, args, out) * self._mult
        if not _is_view(func) and name not in _NO_TRAFFIC \
                and func.namespace != "prim":
            self._traffic(list(_tensors((args, kwargs))), outs, kind,
                          copy=name in _COPIES)
        for t in outs:
            self._track(t)

    def _traffic(self, ins, outs, kind: Optional[str], *,
                 copy: bool = False) -> None:
        n = self._mult
        in_b = sum(_nbytes(t) for t in ins) * n
        out_b = sum(_nbytes(t) for t in outs) * n
        if kind is not None:
            self.collective_bytes[kind] += max(in_b, out_b)
            self.collective_counts[kind] += n
        self.bytes_hbm += in_b + out_b
        if copy:
            self.copy_bytes += out_b
        if self.score_dims is not None:
            self.score_bytes += n * sum(_nbytes(t) for t in ins + outs
                                        if self._is_score(t))

    def _is_score(self, t: torch.Tensor) -> bool:
        kv, qs = self.score_dims[0], self.score_dims[1:]
        return t.dim() >= 2 and t.shape[-1] == kv and t.shape[-2] in qs

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._excluded:
            return
        if key not in self._refs:
            self._refs[key] = 0
            self._sizes[key] = t.untyped_storage().nbytes()
            self.live_bytes += self._sizes[key]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live_bytes -= self._sizes.pop(key)

    def summary(self) -> dict:
        """hlo.py's ``analyze`` keys."""
        return {
            "flops": self.flops,
            "bytes_hbm": self.bytes_hbm,
            "copy_bytes": self.copy_bytes,
            "score_bytes": self.score_bytes,
            "collective_bytes": {**self.collective_bytes,
                                 "total": sum(self.collective_bytes.values())},
            "collective_counts": dict(self.collective_counts),
        }


def repeated(counter: OpCounter, n: int, fn, *xs):
    """``fn(*xs)`` (a tuple of tensors), its ops counted ``n`` times by
    ``counter``, and the backward nodes it creates too: each runs
    between hooks that set the count (a nested ``autograd.grad`` would
    let the engine run other nodes inside it)."""
    with counter.repeat(n):
        outs = fn(*xs)
    stop = {x.grad_fn for x in xs if x.grad_fn is not None}
    todo = [o.grad_fn for o in outs if o.grad_fn is not None]
    seen = set()
    while todo:
        node = todo.pop()
        if node in seen or node in stop \
                or type(node).__name__ == "AccumulateGrad":
            continue
        seen.add(node)
        node.register_prehook(lambda *_: counter._set_mult(n))
        node.register_hook(lambda *_: counter._set_mult(1))
        todo.extend(f for f, _ in node.next_functions if f is not None)
    return outs


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _patch_dtensor(counter: OpCounter):
    """Two hooks into DTensor while the counter is on; returns the undo.

    * Its output-shape propagation (the op run on fake tensors of GLOBAL
      shape) runs with the counter paused.  The counter refuses to run
      without this hook: it would count every op at its global shape.
    * A ``Shard(i) -> Shard(j)`` move counts as the one all-to-all it is
      on the card: on a CPU mesh (the dry run's) DTensor runs it as an
      all-gather and a local chunk.
    """
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    prop = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if n in ShardingPropagator.__dict__), None)
    if prop is None:
        raise RuntimeError("this torch's DTensor has no ShardingPropagator."
                           "_propagate_tensor_meta: the counter cannot "
                           "tell its global-shape propagation from local "
                           "ops")
    orig_prop = ShardingPropagator.__dict__[prop]
    orig_a2a = getattr(placement_types, "shard_dim_alltoall", None)

    def propagate(self, *args, **kwargs):
        with counter.paused():
            return orig_prop(self, *args, **kwargs)

    def all_to_all(input, *args, **kwargs):
        with counter.paused():
            out = orig_a2a(input, *args, **kwargs)
        if not counter._paused:
            counter._traffic([input], [out], "all-to-all")
            counter._track(out)
        return out

    setattr(ShardingPropagator, prop, propagate)
    if orig_a2a is not None:
        placement_types.shard_dim_alltoall = all_to_all

    def undo():
        setattr(ShardingPropagator, prop, orig_prop)
        if orig_a2a is not None:
            placement_types.shard_dim_alltoall = orig_a2a

    return undo
