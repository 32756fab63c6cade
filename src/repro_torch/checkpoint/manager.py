"""Checkpoint manager: async save, atomic commit, restore onto a device.

The JAX package's ``checkpoint/manager.py`` over trees of tensors, writing
the same files.  Fault-tolerance contract:

  * **Atomic**: shards + manifest are written into ``<dir>/.tmp_step_N``,
    fsync'd, then the directory is renamed to ``step_N``.  A crash mid-save
    leaves only a tmp dir the next run garbage-collects; ``latest_step``
    never observes a partial checkpoint.
  * **Async**: ``save`` copies every leaf to host memory synchronously
    (a device-to-host copy) and writes in a background thread, so the
    train loop may update its tensors in place at once.  At most one save
    is in flight; a new save waits for the previous.
  * **Restore**: every leaf comes back in its stored dtype (float32
    moments, the int32 step, bfloat16 parameters as saved) on the device
    the caller names, or, given ``shardings`` (a tree from
    ``launch.shardings.named``), as a DTensor placed on its mesh — the
    elastic restore onto a mesh other than the one that saved, which is
    recorded in the manifest.
  * **Retention**: keep the newest ``keep`` checkpoints, delete older.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from . import format as F


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._save_thread: Optional[threading.Thread] = None
        self._gc_tmp()

    # -- discovery -----------------------------------------------------------
    def _gc_tmp(self) -> None:
        for name in os.listdir(self.directory):
            if name.startswith(".tmp_step_"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                manifest = os.path.join(self.directory, name,
                                        "MANIFEST.bebop")
                if os.path.isfile(manifest):
                    out.append(int(name.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save -------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, data_cursor: int = 0,
             mesh_shape: Tuple[int, ...] = (),
             mesh_axes: Tuple[str, ...] = (),
             config: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Snapshot now, write in the background (unless blocking)."""
        self.wait()
        # snapshot to host memory synchronously so the caller may
        # overwrite the tensors in place immediately after
        snapshot = [(name, _host_copy(leaf))
                    for name, leaf in F.flatten_tree(tree)]

        def work():
            self._write(step, snapshot, data_cursor, mesh_shape, mesh_axes,
                        config)

        if blocking:
            work()
        else:
            self._save_thread = threading.Thread(
                target=work, daemon=True, name=f"ckpt-save-{step}")
            self._save_thread.start()

    def wait(self) -> None:
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None

    def _write(self, step, snapshot, data_cursor, mesh_shape, mesh_axes,
               config) -> None:
        tmp = os.path.join(self.directory, f".tmp_step_{step}")
        final = os.path.join(self.directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        shard_path = os.path.join(tmp, "shard_00000.bebop")
        size = 0
        with open(shard_path, "wb") as f:
            for name, arr in snapshot:
                size += F.write_tensor(f, name, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest = F.encode_manifest(
            step, [{"path": "shard_00000.bebop",
                    "tensor_count": len(snapshot), "byte_size": size}],
            data_cursor=data_cursor, mesh_shape=mesh_shape,
            mesh_axes=mesh_axes, config=config)
        mpath = os.path.join(tmp, "MANIFEST.bebop")
        with open(mpath, "wb") as f:
            f.write(manifest)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._retain()

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------------
    def manifest(self, step: int) -> dict:
        path = os.path.join(self.directory, f"step_{step}",
                            "MANIFEST.bebop")
        with open(path, "rb") as f:
            return F.decode_manifest(f.read())

    def restore(self, step: int, template: Any, *, device=None,
                shardings: Any = None) -> Tuple[Any, dict]:
        """Load ``step`` into the structure of ``template``: tensors of
        their stored dtypes, on ``device`` (the CPU when None).

        ``shardings``: optional tree of ``NamedSharding`` (mesh,
        placements) leaves; each leaf is then distributed onto its mesh,
        as JAX ``device_put``s each leaf to its sharding.
        """
        man = self.manifest(step)
        if not man.get("complete", True):
            raise IOError(f"checkpoint step {step} is incomplete")
        tensors: Dict[str, torch.Tensor] = {}
        base = os.path.join(self.directory, f"step_{step}")
        for shard in man["shards"]:
            with open(os.path.join(base, shard["path"]), "rb") as f:
                buf = f.read()
            for name, arr in F.read_tensors(buf):
                tensors[name] = arr
        if device is not None:
            tensors = {k: v.to(device) for k, v in tensors.items()}
        tree = F.unflatten_tree(template, tensors)
        if shardings is not None:
            tree = _place(tree, shardings)
        return tree, man

    def restore_latest(self, template: Any, *, device=None,
                       shardings: Any = None) -> Optional[Tuple[Any, dict]]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template, device=device,
                            shardings=shardings)


def _place(tree, shardings):
    """Each leaf distributed by the ``NamedSharding`` beside it."""
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    mesh = shardings.mesh
    return distribute_tensor(tree.to(mesh.device_type), mesh,
                             shardings.placements)


def _host_copy(leaf):
    """A host copy of a tensor or array that later writes to ``leaf``
    cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)
