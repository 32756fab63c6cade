"""Training loop: data -> train step -> checkpoint -> telemetry.

The JAX package's ``train/train_loop.py`` on PyTorch:
  * parameters and optimizer state update in place under
    ``torch.no_grad()``, the port's stand-in for JAX's donated buffers
  * gradient compression applied before the data-parallel reduce
  * async checkpointing every ``ckpt_every`` steps + emergency checkpoint
    on preemption (SIGTERM) + restart from latest (params, opt, data cursor)
  * step watchdog for hang detection

The loss is differentiated through the plain attention and scan versions:
the model is built from ``dataclasses.replace(cfg,
attention_impl="reference")``, the JAX ``ModelConfig``'s own default and
how JAX's ``Trainer`` trains.  No kernel of either package has a backward,
and the port's kernel wrappers refuse to launch under grad on an input
that requires grad, so differentiating through a kernel raises.  The
training batch reaches the model as the caller hands it: decoded on the
host by :class:`~repro_torch.data.Pipeline`, or on the card by
:func:`~repro_torch.core.device.decode_page_device` from
:func:`~repro_torch.data.device_batches`' raw pages.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..checkpoint.format import flatten_tree, unflatten_tree
from ..checkpoint.manager import CheckpointManager
from ..configs.base import ModelConfig
from ..core.device import torch_device
from ..models import get_model
from ..models.sharded import placed_like
from . import optimizer as O
from .fault import PreemptionHandler, StepWatchdog


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    seed: int = 0
    watchdog_timeout_s: float = 600.0


def _value_and_grad(model, params, batch) -> Tuple[torch.Tensor, Any]:
    names, flat = zip(*flatten_tree(params))
    live = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        with record_function("train_step/forward"):
            loss = model.loss(unflatten_tree(params, dict(zip(names, live))),
                              batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    # a leaf the loss never reads (an untied embedding under embedding
    # inputs) gets the zero gradient JAX gives it
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten_tree(params, dict(zip(names, grads)))


def loss_and_grads(model, params, batch, grad_accum: int = 1
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of ``model.loss`` at ``params`` on ``batch``.

    grad_accum > 1: the batch is split along its first axis into
    microbatches run one after another (JAX scans them), bounding peak
    activation memory to one microbatch's worth; the loss and the float32
    gradient sums are divided by ``grad_accum``.
    """
    k = grad_accum
    if k <= 1:
        return _value_and_grad(model, params, batch)
    m = batch[next(iter(batch))].shape[0] // k
    dev = next(O.leaves(params)).device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    grads = O.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
    for i in range(k):
        # microbatch i: rows [i * m, (i + 1) * m), as JAX's reshape to
        # [k, m, ...] cuts them; on DTensors placed as the whole batch
        lv, g = _value_and_grad(model, params,
                                {n: placed_like(x[i * m:(i + 1) * m], x)
                                 for n, x in batch.items()})
        loss = loss + lv
        O.tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
    return loss / k, O.tree_map(lambda g: g / k, grads)


def make_train_step(model, opt_cfg: O.OptimizerConfig
                    ) -> Callable[..., Tuple[Any, Any, torch.Tensor]]:
    """(params, opt_state, batch) -> (params', opt_state', loss), the
    parameters and moments updated in place.  The forward and the optimizer
    run in ``torch.profiler`` ranges named ``train_step/forward`` and
    ``train_step/optimizer`` (no cost when no profiler runs)."""
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch,
                                     opt_cfg.grad_accum)
        with record_function("train_step/optimizer"):
            grads, opt_state = O.compress_grads(grads, opt_state, opt_cfg)
            params, opt_state = O.adamw_update(grads, opt_state, params,
                                               opt_cfg)
        return params, opt_state, loss

    return train_step


class Trainer:
    """The JAX ``Trainer``'s constructor and loop, on ``device`` (the card
    unless the caller passes ``device="cpu"``).  ``data`` yields
    ``(batch, cursor)``: a batch of numpy arrays or tensors, moved to the
    device here.  ``mesh``, a ``DeviceMesh``, is recorded (shape and axis
    names) in every checkpoint's manifest; as in JAX, the step is not
    sharded by it.  With ``donate=False`` each step updates a copy, so
    tensors the caller took from an earlier step keep their values."""

    def __init__(self, cfg: ModelConfig, opt_cfg: O.OptimizerConfig,
                 train_cfg: TrainConfig, *,
                 data: Iterator[Tuple[Dict[str, Any], int]],
                 mesh=None, donate: bool = True, device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.opt_cfg = opt_cfg
        self.train_cfg = train_cfg
        self.data = data
        self.device = torch_device(device)
        self.model = get_model(dataclasses.replace(
            cfg, attention_impl="reference"))
        self.donate = donate
        self.step = 0
        self.data_cursor = 0
        self.metrics: list = []

        self.params = self.model.init(train_cfg.seed, self.device)
        self.opt_state = O.init_opt_state(self.params, opt_cfg)
        self._train_step = make_train_step(self.model, opt_cfg)

        self.ckpt: Optional[CheckpointManager] = None
        if train_cfg.ckpt_dir:
            self.ckpt = CheckpointManager(train_cfg.ckpt_dir)
            self._maybe_restore()

        self.preemption = PreemptionHandler().install()
        self.watchdog = StepWatchdog(train_cfg.watchdog_timeout_s)

    # -- checkpoint/restart -------------------------------------------------
    def _maybe_restore(self) -> None:
        assert self.ckpt is not None
        latest = self.ckpt.latest_step()
        if latest is None:
            return
        tree = {"params": self.params, "opt": self.opt_state}
        restored, man = self.ckpt.restore(latest, tree, device=self.device)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = int(man["step"])
        self.data_cursor = int(man.get("data_cursor", 0))

    def _save(self, blocking: bool = False) -> None:
        if self.ckpt is None:
            return
        mesh_shape = tuple(self.mesh.shape) if self.mesh is not None else ()
        mesh_axes = tuple(self.mesh.mesh_dim_names) \
            if self.mesh is not None else ()
        self.ckpt.save(self.step,
                       {"params": self.params, "opt": self.opt_state},
                       data_cursor=self.data_cursor,
                       mesh_shape=mesh_shape, mesh_axes=mesh_axes,
                       config={"arch": self.cfg.name},
                       blocking=blocking)

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def _close(self) -> None:
        self.watchdog.stop()
        self.preemption.uninstall()

    # -- loop ------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        tc = self.train_cfg
        tokens_per_batch = None
        t_start = time.monotonic()
        losses = []
        while self.step < tc.steps:
            if self.preemption.preempted:
                self._save(blocking=True)
                self._close()
                return {"status": "preempted", "step": self.step,
                        "losses": losses}
            try:
                batch, cursor = next(self.data)
            except StopIteration:
                break
            if tokens_per_batch is None:
                key = "tokens" if "tokens" in batch else \
                    ("embeds" if "embeds" in batch else "frames")
                tokens_per_batch = int(np.prod(batch[key].shape[:2]))
            params, opt_state = self.params, self.opt_state
            if not self.donate:
                params = O.tree_map(torch.clone, params)
                opt_state = O.tree_map(torch.clone, opt_state)
            self.watchdog.step_started()
            self.params, self.opt_state, loss = self._train_step(
                params, opt_state, self._batch(batch))
            self.watchdog.step_finished()
            self.step += 1
            self.data_cursor = cursor
            if self.step % tc.log_every == 0 or self.step == tc.steps:
                lv = float(loss)
                losses.append((self.step, lv))
                dt = time.monotonic() - t_start
                tps = self.step * (tokens_per_batch or 0) / max(dt, 1e-9)
                self.metrics.append(
                    {"step": self.step, "loss": lv, "tokens_per_s": tps})
            if self.ckpt is not None and self.step % tc.ckpt_every == 0:
                self._save()
        self._save(blocking=True)
        if self.ckpt is not None:
            self.ckpt.wait()
        self._close()
        return {"status": "done", "step": self.step, "losses": losses,
                "metrics": self.metrics}
