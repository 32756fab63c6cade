"""Checkpoint format: Bebop throughout, the JAX package's own bytes.

Layout on disk:

    step_000042/
      MANIFEST.bebop        # Manifest message (evolvable: new fields safe)
      shard_00000.bebop     # TensorRecord stream
      ...

The messages are the JAX package's ``checkpoint/format.py`` field for
field, and trees flatten in the JAX tree's order with its names (sorted
dict keys, ``/``-joined), so a checkpoint either package writes the other
restores, and one tree writes byte-equal shards in both.  Tensor payloads
are raw little-endian bytes behind a 4-byte length.  A bfloat16 leaf is
written as its 16 bits under the dtype name ``bfloat16`` and read back as
those bits viewed as ``torch.bfloat16``: no ``ml_dtypes`` on either side
of the port.  A 0-d leaf (the optimizer's step) is stored with shape
``[1]``, as the JAX writer's ``np.ascontiguousarray`` stores it; the port
restores it into a 0-d template leaf as 0-d, where the JAX reader returns
shape ``(1,)``.
"""
from __future__ import annotations

import io
import json
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import types as T
from ..core import wire

# -- schema ------------------------------------------------------------------

TensorRecord = T.Message("TensorRecord", [
    T.Field("name", T.STRING, tag=1),          # pytree path, '/'-joined
    T.Field("dtype", T.STRING, tag=2),         # numpy dtype string
    T.Field("shape", T.Array(T.UINT32), tag=3),
    T.Field("data", T.Array(T.BYTE), tag=4),   # raw LE bytes
    T.Field("crc32", T.UINT32, tag=5),
])

ShardInfo = T.Message("ShardInfo", [
    T.Field("path", T.STRING, tag=1),
    T.Field("tensor_count", T.UINT32, tag=2),
    T.Field("byte_size", T.UINT64, tag=3),
])

Manifest = T.Message("Manifest", [
    T.Field("step", T.UINT64, tag=1),
    T.Field("created", T.TIMESTAMP, tag=2),
    T.Field("shards", T.Array(ShardInfo), tag=3),
    T.Field("data_cursor", T.UINT64, tag=4),     # pipeline restart point
    T.Field("mesh_shape", T.Array(T.UINT32), tag=5),
    T.Field("mesh_axes", T.Array(T.STRING), tag=6),
    T.Field("config_json", T.STRING, tag=7),
    T.Field("framework_version", T.STRING, tag=8),
    T.Field("complete", T.BOOL, tag=9),          # atomic-commit marker
])

#: torch dtype <-> the numpy dtype name a record carries
DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
               torch.float16: "float16", torch.bfloat16: "bfloat16",
               torch.int8: "int8", torch.int16: "int16",
               torch.int32: "int32", torch.int64: "int64",
               torch.uint8: "uint8", torch.bool: "bool"}
TORCH_DTYPES = {v: k for k, v in DTYPE_NAMES.items()}


# -- tensor stream ----------------------------------------------------------------


def flatten_tree(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) over a tree of nested dicts in the JAX tree's order:
    sorted keys, names ``/``-joined."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flatten_tree(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def unflatten_tree(template, tensors: Dict[str, Any], prefix: str = ""):
    """``template``'s structure with each leaf taken from ``tensors`` by
    its name."""
    out = {}
    for k, v in template.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = unflatten_tree(v, tensors, name + "/")
        elif name not in tensors:
            raise KeyError(f"checkpoint missing tensor {name}")
        else:
            t = tensors[name]
            if getattr(v, "shape", None) == () and t.numel() == 1:
                t = t.reshape(())
            out[k] = t
    return out


def _raw(leaf) -> Tuple[str, Tuple[int, ...], bytes]:
    """(dtype name, shape, little-endian bytes) of a tensor or array."""
    if isinstance(leaf, torch.Tensor):
        # a 0-d leaf becomes [1], as np.ascontiguousarray makes it
        t = leaf.detach().to("cpu").reshape(leaf.shape or (1,)).contiguous()
        return (DTYPE_NAMES[t.dtype], tuple(t.shape),
                t.reshape(-1).view(torch.uint8).numpy().tobytes())
    arr = np.ascontiguousarray(leaf)
    return arr.dtype.name, arr.shape, arr.tobytes()


def write_tensor(out: io.BufferedIOBase, name: str, leaf) -> int:
    dtype, shape, data = _raw(leaf)
    rec = wire.encode(TensorRecord, {
        "name": name, "dtype": dtype,
        "shape": np.asarray(shape, dtype="<u4"),
        "data": data, "crc32": zlib.crc32(data),
    })
    out.write(rec)
    return len(rec)


def read_tensors(buf: bytes, *, verify: bool = True
                 ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor of the stored dtype and shape) for each record."""
    pos = 0
    n = len(buf)
    while pos < n:
        rec, pos = wire.decode_with_end(TensorRecord, buf, offset=pos)
        data = np.asarray(rec["data"], dtype="u1")
        if verify and "crc32" in rec and zlib.crc32(data) != rec["crc32"]:
            raise T.DecodeError(f"tensor {rec['name']}: CRC mismatch")
        if rec["dtype"] not in TORCH_DTYPES:
            raise T.DecodeError(f"tensor {rec['name']}: unsupported dtype "
                                f"{rec['dtype']}")
        t = torch.from_numpy(data.copy()).view(TORCH_DTYPES[rec["dtype"]])
        yield rec["name"], t.reshape([int(s) for s in rec["shape"]])


def encode_manifest(step: int, shards: List[dict], *, data_cursor: int = 0,
                    mesh_shape: Tuple[int, ...] = (),
                    mesh_axes: Tuple[str, ...] = (),
                    config: Optional[dict] = None,
                    complete: bool = True) -> bytes:
    return wire.encode(Manifest, {
        "step": step,
        "created": T.Timestamp.from_unix(time.time()),
        "shards": shards,
        "data_cursor": data_cursor,
        "mesh_shape": np.asarray(mesh_shape, dtype="<u4"),
        "mesh_axes": list(mesh_axes),
        "config_json": json.dumps(config or {}),
        "framework_version": "1.0.0",
        "complete": complete,
    })


def decode_manifest(buf: bytes) -> dict:
    return wire.decode(Manifest, buf)
