"""Production mesh definition, on ``torch.distributed.device_mesh``.

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model") — the
"pod" axis is pure data parallelism across node-group boundaries.

The JAX package's ``launch/mesh.py`` over a process group: a mesh takes
the first ranks of the default group, which must exist (``launch/dryrun.py``
creates a fake one of 512 ranks; a real job creates it with NCCL).
Defined as FUNCTIONS so importing this module never touches the process
group or a device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.device import torch_device


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device: str
          ) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, the default process group "
            f"has {have} — run through launch/dryrun.py (it creates a fake "
            f"group of 512 ranks before any mesh)")
    # more ranks than needed (the single-pod mesh under a 512-rank group)
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The (16, 16) or (2, 16, 16) mesh over the first ranks of the
    default group: on the card under NCCL, else on the CPU (the dry run's
    fake group)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    device = "cuda" if dist.is_initialized() \
        and dist.get_backend() == "nccl" else "cpu"
    return _mesh(shape, axes, device)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device: str = "cuda") -> DeviceMesh:
    return _mesh(tuple(shape), tuple(axes), torch_device(device).type)


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """1-rank mesh with the production axis names, on the card unless the
    caller passes ``device="cpu"``.  Sets up a one-rank process group
    (NCCL on the card, gloo on the CPU) when none exists."""
    dev = torch_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return _mesh((1, 1), ("data", "model"), dev.type)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The pure-data-parallel axes of a mesh (pod included when present)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, name: str) -> int:
    if name not in mesh.mesh_dim_names:
        return 1
    return tuple(mesh.shape)[mesh.mesh_dim_names.index(name)]


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= axis_size(mesh, a)
    return n
