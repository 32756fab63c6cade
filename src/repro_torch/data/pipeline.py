"""Sharded, restartable, straggler-tolerant data pipeline.

A copy of the JAX package's ``data/pipeline.py`` (host code): the same
sharding, cursors and hedging, so a cursor either package checkpoints
resumes the other at the same record.

Design (large-scale runnability):

  * **Deterministic sharding**: host h of H owns records where
    ``(record_index // batch_shard) % H == h``.  No coordination needed; a
    restarted host recomputes its shard from the cursor alone.
  * **Cursors everywhere**: the pipeline state is ONE integer (global record
    index), checkpointed with the model.  Restart = seek_cursor (§7.5's
    stream cursor applied to data).
  * **Hedged reads** (straggler mitigation): the prefetcher issues a backup
    read when a page source exceeds its latency SLO, takes whichever
    completes first, and cancels the loser.  Sources are pluggable
    (local file / RPC / object store); the test suite injects a slow source
    to verify hedging.
  * **Device decode**: batches can be yielded as raw ``[N, stride]`` u8
    payloads for kernels/bebop_decode.py, so the host never parses tokens.
"""
from __future__ import annotations

import concurrent.futures as _cf
import dataclasses
import queue
import threading
import time
from typing import Callable, Iterator, List, Tuple

import numpy as np

from ..core import pages
from . import records


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_index: int = 0
    records_per_page: int = 64
    hedge_after_s: float = 0.5      # straggler SLO before hedging
    prefetch: int = 2
    verify_crc: bool = True

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


PageSource = Callable[[int], bytes]
"""A page source maps page_index -> page bytes (may be slow / remote)."""


class HedgedReader:
    """Issue a backup read when the primary exceeds the SLO (§ straggler)."""

    def __init__(self, sources: List[PageSource], hedge_after_s: float):
        if not sources:
            raise ValueError("need at least one page source")
        self.sources = sources
        self.hedge_after_s = hedge_after_s
        self.hedged_reads = 0
        self.total_reads = 0
        self._pool = _cf.ThreadPoolExecutor(max_workers=2 * len(sources))

    def read(self, page_index: int) -> bytes:
        self.total_reads += 1
        primary = self._pool.submit(self.sources[0], page_index)
        try:
            return primary.result(timeout=self.hedge_after_s)
        except _cf.TimeoutError:
            pass
        # primary is straggling: hedge to the backup source (or retry)
        self.hedged_reads += 1
        backup_fn = self.sources[1 % len(self.sources)]
        backup = self._pool.submit(backup_fn, page_index)
        done, _ = _cf.wait([primary, backup],
                           return_when=_cf.FIRST_COMPLETED)
        for f in done:
            if not f.cancelled() and f.exception() is None:
                return f.result()
        # both raced to failure: propagate whichever error
        return primary.result()


class BufferSource:
    """Page source over an in-memory buffer (pages written consecutively)."""

    def __init__(self, buf: bytes, *, delay_s: float = 0.0,
                 delay_every: int = 0):
        self.buf = buf
        self.offsets = list(pages.iter_pages(buf))
        self.delay_s = delay_s
        self.delay_every = delay_every
        self._reads = 0

    def __len__(self):
        return len(self.offsets)

    def __call__(self, page_index: int) -> bytes:
        self._reads += 1
        if self.delay_every and self._reads % self.delay_every == 0:
            time.sleep(self.delay_s)   # injected straggler
        off = self.offsets[page_index]
        h = pages.read_header(self.buf, off)
        return self.buf[off:off + pages.page_size(h)]


class FileSource:
    """Page source over an on-disk page file (offset index built once)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        self._buf = data
        self.offsets = list(pages.iter_pages(data))

    def __len__(self):
        return len(self.offsets)

    def __call__(self, page_index: int) -> bytes:
        off = self.offsets[page_index]
        h = pages.read_header(self._buf, off)
        return self._buf[off:off + pages.page_size(h)]


class Pipeline:
    """Cursor-driven batch iterator with background prefetch + hedging."""

    def __init__(self, cfg: DataConfig, sources: List[PageSource],
                 num_pages: int, *, cursor: int = 0):
        self.cfg = cfg
        self.reader = HedgedReader(sources, cfg.hedge_after_s)
        self.num_pages = num_pages
        self.cursor = cursor  # global record index (checkpointed)
        self.struct = records.train_example_struct(cfg.seq_len)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="data-prefetch")
        self._thread.start()

    # -- producer ------------------------------------------------------------
    def _produce(self) -> None:
        cfg = self.cfg
        hb = cfg.host_batch
        pending: List[np.ndarray] = []
        pend_count = 0
        consumed = self.cursor   # global record index already consumed
        idx = 0
        while not self._stop.is_set():
            if idx >= self.num_pages:
                self._q.put(None)
                return
            # deterministic host sharding: host h takes interleaved pages
            if (idx % cfg.num_hosts) != cfg.host_index:
                idx += 1
                continue
            page = self.reader.read(idx)
            idx += 1
            h = pages.read_header(page)
            end_rec = h.first_record + h.record_count
            if end_rec <= consumed:
                continue  # restart skip-ahead: page fully before the cursor
            recs = pages.decode_page(self.struct, page,
                                     verify=cfg.verify_crc)
            lo = max(consumed - h.first_record, 0)
            take = recs["tokens"][lo:]
            pending.append(take)
            pend_count += len(take)
            consumed = end_rec
            while pend_count >= hb:
                cat = np.concatenate(pending) if len(pending) > 1 \
                    else pending[0]
                batch = cat[:hb]
                cursor_after = consumed - (pend_count - hb)
                self._q.put((batch.astype(np.int32), cursor_after))
                pending = [cat[hb:]] if pend_count > hb else []
                pend_count -= hb

    # -- consumer --------------------------------------------------------------
    def __iter__(self) -> Iterator[Tuple[dict, int]]:
        while True:
            item = self._q.get()
            if item is None:
                return
            tokens, cursor = item
            self.cursor = cursor
            yield ({"tokens": tokens[:, :-1],
                    "labels": tokens[:, 1:].astype(np.int32)}, cursor)

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    @property
    def hedged_fraction(self) -> float:
        r = self.reader
        return r.hedged_reads / max(r.total_reads, 1)


def device_batches(pipeline_buf: bytes, cfg: DataConfig, *, cursor: int = 0
                   ) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield raw [host_batch, stride] u8 payloads for on-device decode."""
    s = records.train_example_struct(cfg.seq_len)
    start = pages.seek_cursor(pipeline_buf, cursor)
    if start is None:
        return
    pend: List[np.ndarray] = []
    count = 0
    hb = cfg.host_batch
    for off in pages.iter_pages(pipeline_buf):
        if off < start:
            continue
        h = pages.read_header(pipeline_buf, off)
        payload = pages.read_payload(pipeline_buf, off,
                                     verify=cfg.verify_crc,
                                     expect_schema=s.name)
        lo = max(cursor - h.first_record, 0)
        pend.append(payload[lo:])
        count = h.first_record + h.record_count
        total = sum(len(p) for p in pend)
        while total >= hb:
            cat = np.concatenate(pend) if len(pend) > 1 else pend[0]
            yield cat[:hb], count - (total - hb)
            pend = [cat[hb:]] if total > hb else []
            total -= hb
