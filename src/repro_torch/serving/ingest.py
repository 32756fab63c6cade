"""Wire->device ingest: page payloads become model-ready tensors.

A port of the JAX package's ``serving/ingest.py``.  Admission does three
things, none of which parses a value on the host:

  1. header validation (magic / version / CRC);
  2. raw device placement — the payload bytes are staged through a
     pinned host buffer and copied to the card unmodified;
  3. kernel decode — ``decode_columns`` (``kernels/bebop_decode.py``)
     materializes every column in one pass, driven by a *decode plan*
     computed once per schema and cached by the header's ``schema_hash``.

The CUDA kernel masks the ragged edge itself, so pages are not padded to
a power-of-two record count as the JAX path pads them for its jit cache;
the columns are bit-identical all the same.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core import pages
from ..core import types as T
from ..core.device import (DeviceLayout, default_out_dtype,
                           plan_device_layout, torch_device)
from ..core.hashing import schema_hash
from ..kernels.bebop_decode import decode_columns
from ..utils import spans


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Everything the decode kernel needs, precomputed per schema."""

    struct: T.Struct
    layout: DeviceLayout
    fields: Tuple[Tuple[int, int, str, str], ...]

    @property
    def stride(self) -> int:
        return self.layout.stride


class PlanCache:
    """schema_hash -> DecodePlan.  Thread-safe; hit/miss counters."""

    def __init__(self):
        self._plans: Dict[int, DecodePlan] = {}
        self._lock = threading.Lock()
        self.hits = 0    # guarded by _lock
        self.misses = 0  # guarded by _lock

    def register(self, s: T.Struct,
                 out_dtypes: Optional[Dict[str, str]] = None) -> DecodePlan:
        """Plan a struct's device layout and index it by schema hash."""
        layout = plan_device_layout(s)
        out_dtypes = out_dtypes or {}
        fields = tuple(
            c.as_field(out_dtypes.get(c.name, default_out_dtype(c.wire_dtype)))
            for c in layout.columns)
        plan = DecodePlan(s, layout, fields)
        with self._lock:
            self._plans[schema_hash(s.name)] = plan
        return plan

    def lookup(self, shash: int) -> DecodePlan:
        with self._lock:
            plan = self._plans.get(shash)
            if plan is None:
                self.misses += 1
            else:
                self.hits += 1
        if plan is None:
            raise pages.PageError(
                f"no decode plan registered for schema hash {shash:#010x}")
        return plan


@dataclasses.dataclass
class IngestResult:
    """One admitted page: header + device-resident decoded columns."""

    header: pages.PageHeader
    plan: DecodePlan
    columns: Dict[str, torch.Tensor]     # name -> [N, count] device tensor


class PageIngest:
    """Admission path: raw page bytes -> device-decoded column tensors.

    ``device`` defaults to ``"cuda"`` and raises when there is no card;
    ``device="cpu"`` decodes with the kernel's plain PyTorch version.
    """

    def __init__(self, cache: Optional[PlanCache] = None, *, device="cuda"):
        self.cache = cache or PlanCache()
        self.device = torch_device(device)
        self.stats = {"pages": 0, "records": 0, "payload_bytes": 0,
                      "rejected": 0}

    def register(self, s: T.Struct,
                 out_dtypes: Optional[Dict[str, str]] = None) -> DecodePlan:
        return self.cache.register(s, out_dtypes)

    def admit(self, buf, offset: int = 0, *, deadline=None) -> IngestResult:
        """Validate the page at ``offset``, place it on the device, decode
        every column.  With spans on, an admitted page is
        ``ingest.admit``."""
        t0 = spans.now() if spans.on else 0
        try:
            header = pages.read_header(buf, offset)
            if deadline is not None and deadline.expired():
                raise pages.PageError("deadline expired before placement")
            plan = self.cache.lookup(header.schema_hash)
            if header.record_stride != plan.stride:
                raise pages.PageError(
                    f"stride mismatch: page {header.record_stride}, "
                    f"plan {plan.stride}")
            payload = pages.read_payload(buf, offset)
        except pages.PageError:
            self.stats["rejected"] += 1
            raise
        columns = self._decode(payload, plan)
        self.stats["pages"] += 1
        self.stats["records"] += header.record_count
        self.stats["payload_bytes"] += header.record_count \
            * header.record_stride
        if t0:
            spans.add("ingest.admit", t0, records=header.record_count,
                      bytes=header.record_count * header.record_stride)
        return IngestResult(header, plan, columns)

    def admit_stream(self, buf, *, cursor: int = 0,
                     deadline=None) -> Iterator[IngestResult]:
        """Admit consecutive pages, skipping whole pages below ``cursor``
        (a global record index: the resume point of a page stream)."""
        start = pages.seek_cursor(buf, cursor)
        if start is None:
            return
        for off in pages.iter_pages(buf):
            if off < start:
                continue
            yield self.admit(buf, off, deadline=deadline)

    def _place(self, payload: np.ndarray) -> torch.Tensor:
        """Raw payload bytes -> an ``[N, stride]`` uint8 tensor on the
        device.  On a card the one host copy lands in pinned memory, so
        the upload is a DMA that does not stall the host."""
        if self.device.type == "cpu":
            return torch.from_numpy(np.array(payload, dtype=np.uint8))
        staged = torch.empty(payload.shape, dtype=torch.uint8,
                             pin_memory=True)
        staged.numpy()[...] = payload
        return staged.to(self.device, non_blocking=True)

    def _decode(self, payload: np.ndarray, plan: DecodePlan
                ) -> Dict[str, torch.Tensor]:
        outs = decode_columns(self._place(payload), plan.fields)
        return {c.name: o for c, o in zip(plan.layout.columns, outs)}
