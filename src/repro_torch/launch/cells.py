"""Dry-run cell construction: abstract inputs, shardings and step functions
for every (arch x shape) combination — the JAX package's
``launch/cells.py`` on DTensor.  Kept import-safe (nothing touches a
process group or a device at module import).

Where JAX lowers and compiles a step against abstract arrays, a
:class:`Cell` runs the port's step once on DTensors whose local shards
are fake tensors (``FakeTensorMode``: shapes and dtypes, no memory),
under :class:`~repro_torch.utils.op_count.OpCounter`.  The model runs
with ``attention_impl="reference"``: the kernels take plain CUDA tensors
and no DTensor, and JAX's dry run lowers its XLA reference too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..checkpoint.format import flatten_tree
from ..configs.base import (ModelConfig, ShapeConfig, SHAPES, get_config,
                            supports_long_context)
from ..models import get_model
from ..train import optimizer as O
from ..train.train_loop import make_train_step
from ..kernels import rglru_scan as _rg
from ..kernels import rwkv6_scan as _rw
from ..utils.op_count import OpCounter, repeated
from . import shardings as S
from .mesh import dp_axes, dp_size

P = S.PartitionSpec


@dataclasses.dataclass
class CellOverrides:
    """Hillclimb levers (§Perf)."""
    remat: Optional[str] = None
    loss_chunk: Optional[int] = None
    compression: Optional[str] = None       # grad compression
    expert_parallel: bool = False
    zero: bool = True
    moment_dtype: str = "float32"
    param_dtype: Optional[str] = None
    rwkv_impl: Optional[str] = None         # sequential | chunked
    rwkv_chunk: Optional[int] = None
    sharding: str = "tp"                    # tp | fsdp
    moe_dispatch: Optional[str] = None      # grouped | global
    grad_accum: int = 1


def arch_shape_cells():
    """All (arch, shape) dry-run cells, with skip annotations."""
    from ..configs import ARCH_IDS, load_all
    load_all()
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skip = None
            if shape.name == "long_500k" and not supports_long_context(cfg):
                skip = ("pure full-attention arch: long_500k needs "
                        "sub-quadratic attention (DESIGN.md §Arch-applicability)")
            cells.append((arch, shape.name, skip))
    return cells


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                fake_mode: Optional[FakeTensorMode] = None
                ) -> Dict[str, torch.Tensor]:
    """Fake-tensor stand-ins for every model input — no allocation."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    bf16 = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    with fake_mode or FakeTensorMode():
        if shape.kind == "decode":
            return {"tokens": torch.empty((b, 1), dtype=i32)}
        if cfg.input_kind == "embeddings":
            out = {"embeds": torch.empty((b, s, cfg.d_model), dtype=bf16),
                   "positions": torch.empty((3, b, s), dtype=i32)}
        elif cfg.input_kind == "frames":
            out = {"frames": torch.empty(
                (b, max(s // cfg.frame_ratio, 1), cfg.d_model), dtype=bf16),
                "tokens": torch.empty((b, s), dtype=i32)}
        else:
            out = {"tokens": torch.empty((b, s), dtype=i32)}
        if shape.kind == "train":
            out["labels"] = torch.empty((b, s), dtype=i32)
        return out


def effective_config(arch: str, shape_name: str,
                     ov: Optional[CellOverrides] = None) -> ModelConfig:
    """JAX's policy, plus ``attention_impl="reference"`` (the JAX
    config's own default)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    kw: Dict[str, Any] = {"attention_impl": "reference"}
    ov = ov or CellOverrides()
    # baseline policy: full remat for training (fits activations at 4k x 256),
    # chunked vocab loss for big-vocab archs
    if shape.kind == "train":
        kw["remat"] = ov.remat if ov.remat is not None else "full"
        if ov.loss_chunk is not None:
            kw["loss_chunk"] = ov.loss_chunk
    else:
        if ov.remat is not None:
            kw["remat"] = ov.remat
    if ov.param_dtype:
        kw["dtype"] = ov.param_dtype
    if ov.rwkv_impl:
        kw["rwkv_impl"] = ov.rwkv_impl
    if ov.rwkv_chunk:
        kw["rwkv_chunk"] = ov.rwkv_chunk
    if ov.moe_dispatch:
        kw["moe_dispatch"] = ov.moe_dispatch
    if ov.sharding == "fsdp":
        kw["fsdp_per_layer_gather"] = True
    return dataclasses.replace(cfg, **kw)


@dataclasses.dataclass
class Traced:
    """One traced step: its counter, the seconds its inputs took to build
    and the step to run on fake shards, and the local bytes of its inputs
    and outputs (outputs that are its inputs updated in place count as
    aliased)."""
    counter: OpCounter
    build_s: float
    seconds: float
    argument_bytes: int
    output_bytes: int
    alias_bytes: int


@contextlib.contextmanager
def _scans_one_step(counter: OpCounter):
    """The plain scans (the model's ``attention_impl="reference"`` path)
    traced one step on fake shards and counted T times with their
    backward (:func:`~repro_torch.utils.op_count.repeated`, hlo.py's rule
    for a while body), the output expanded to T: at ~150 µs a fake op,
    tracing every step would take hours (4,096 x 32 WKV steps)."""
    swaps = [(_rg, "rglru_scan_plain", 1, 2), (_rw, "rwkv6_scan_plain", 2, 4)]
    saved = [getattr(mod, name) for mod, name, _, _ in swaps]
    for (mod, name, time_dim, n_timed), fn in zip(swaps, saved):
        setattr(mod, name, _one_step(counter, fn, time_dim, n_timed))
    try:
        yield
    finally:
        for (mod, name, _, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def _one_step(counter: OpCounter, fn, time_dim: int, n_timed: int):
    """``fn``, a scan whose first ``n_timed`` inputs and first output run
    along ``time_dim``, run on the first step and counted T times."""
    def run(*xs):
        t = xs[0].shape[time_dim]
        first = [x.narrow(time_dim, 0, 1) if i < n_timed else x
                 for i, x in enumerate(xs)]
        out, last = repeated(counter, t, fn, *first)
        return out.expand(*out.shape[:time_dim], t,
                          *out.shape[time_dim + 1:]), last

    return run


def _local_leaves(tree):
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _leaves(tree)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for _, t in flatten_tree(tree)]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Cell:
    """One (arch x shape x mesh) dry-run unit: build -> trace."""

    def __init__(self, arch: str, shape_name: str, mesh,
                 overrides: Optional[CellOverrides] = None):
        self.arch = arch
        self.shape = SHAPES[shape_name]
        self.mesh = mesh
        self.ov = overrides or CellOverrides()
        self.cfg = effective_config(arch, shape_name, self.ov)
        self.model = get_model(self.cfg)
        self.fake = FakeTensorMode()

    # -- abstract trees ------------------------------------------------------
    def abstract_params(self):
        with self.fake:
            return self.model.init(0, torch.device("cpu"))

    def opt_config(self) -> O.OptimizerConfig:
        return O.OptimizerConfig(
            compression=self.ov.compression or "none",
            moment_dtype=self.ov.moment_dtype,
            grad_accum=self.ov.grad_accum)

    def trip_count(self) -> int:
        """The JAX scan's trip count, kept in the record (the port's
        layers loop in Python)."""
        cfg = self.cfg
        if cfg.block_pattern:
            return (cfg.num_layers - len(cfg.tail_pattern)) \
                // len(cfg.block_pattern)
        return cfg.num_layers

    def _distribute(self, tree, spec_tree):
        """Fake global tensors -> DTensors of fake local shards."""
        mesh = self.mesh

        def one(spec, t):
            pl = S.placements(mesh, spec)
            local = torch.empty(S.local_shape(t.shape, mesh, pl),
                                dtype=t.dtype, device=mesh.device_type)
            return DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=t.shape, stride=t.stride())

        with self.fake:
            return S.tree_map_specs(one, spec_tree, tree)

    # -- tracing ---------------------------------------------------------------
    def trace(self, score_dims=None) -> Traced:
        """Build the cell's step on DTensors and run it once under the
        counter."""
        kind = self.shape.kind
        t0 = time.monotonic()
        params_abs = self.abstract_params()
        pspecs = S.param_specs(self.cfg, params_abs, self.mesh,
                               expert_parallel=self.ov.expert_parallel,
                               mode=self.ov.sharding)
        params = self._distribute(params_abs, pspecs)
        if kind == "train":
            args, step = self._train(params_abs, params, pspecs)
        elif kind == "prefill":
            args, step = self._prefill(params)
        else:
            args, step = self._decode(params)
        counter = OpCounter(score_dims=score_dims, arguments=args)
        t1 = time.monotonic()
        with self.fake, implicit_replication(), counter, \
                _scans_one_step(counter):
            out = step(*args)
        seconds = time.monotonic() - t1
        ins = _local_leaves(args)
        outs = _local_leaves(out)
        arg_storages = {t.untyped_storage()._cdata for t in ins}
        aliased = [t for t in outs
                   if t.untyped_storage()._cdata in arg_storages]
        return Traced(counter, t1 - t0, seconds, _nbytes(ins), _nbytes(outs),
                      _nbytes(aliased))

    def _batch(self):
        cfg, mesh = self.cfg, self.mesh
        bspecs = S.batch_specs(cfg, self.shape, mesh, mode=self.ov.sharding)
        return self._distribute(input_specs(cfg, self.shape, self.fake),
                                bspecs)

    def _train(self, params_abs, params, pspecs):
        mesh = self.mesh
        opt_cfg = self.opt_config()
        with self.fake:
            opt_abs = O.init_opt_state(params_abs, opt_cfg)
        mom_specs = S.zero_specs(pspecs, params_abs, mesh) if self.ov.zero \
            else pspecs
        ospecs = {"m": mom_specs, "v": mom_specs, "step": P()}
        if opt_cfg.compression == "int8":
            ospecs["ef"] = mom_specs
        opt = self._distribute(opt_abs, ospecs)
        return (params, opt, self._batch()), \
            make_train_step(self.model, opt_cfg)

    def _prefill(self, params):
        cfg, mesh = self.cfg, self.mesh
        cache_len = self.shape.seq_len

        def prefill(params, batch):
            logits, cache = self.model.prefill(params, batch, cache_len)
            # JAX's out_shardings: the cache leaves the step placed by
            # cache_specs
            cspecs = S.cache_specs(cfg, cache, mesh)
            return logits, S.distribute(cache, mesh, cspecs)

        return (params, self._batch()), prefill

    def _decode(self, params):
        cfg, mesh = self.cfg, self.mesh
        b, s = self.shape.global_batch, self.shape.seq_len
        with self.fake:
            cache_abs = self.model.init_cache(b, s, torch.device("cpu"))
        cache = self._distribute(cache_abs,
                                 S.cache_specs(cfg, cache_abs, mesh))
        dp = dp_axes(mesh)
        dpn = dp if len(dp) > 1 else (dp[0] if dp else None)
        tok_spec = P(dpn, None) if b % dp_size(mesh) == 0 else P(None, None)
        tokens = self._distribute(input_specs(cfg, self.shape, self.fake),
                                  {"tokens": tok_spec})["tokens"]

        def decode(params, tokens, cache):
            # the token at the last slot of a full cache (JAX traces pos)
            return self.model.decode_step(params, tokens, cache, s - 1)

        return (params, tokens, cache), decode
