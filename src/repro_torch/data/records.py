"""Training data as Bebop records.

A copy of the JAX package's ``data/records.py`` (host code: numpy and the
port's page codec), so both packages write and read the same pages.

A training example is a Bebop *struct* (hot path: positional, zero overhead):

    struct TrainExample {
      doc_id: uuid;              // 16 bytes, keeps the payload 4-aligned
      tokens: uint32[seq_len+1]; // fixed array: inputs + shifted labels
    }

Records pack into checksummed 512-byte-aligned pages (core/pages.py) whose
payload is a dense [N, stride] byte matrix — decodable on the host as one
``np.frombuffer`` or on the card with ``kernels/bebop_decode.py``.
"""
from __future__ import annotations

import uuid as _uuid
from typing import Iterator, Optional, Tuple

import numpy as np

from ..core import fastwire, pages
from ..core import types as T
from ..core.device import DeviceLayout, plan_device_layout


def train_example_struct(seq_len: int) -> T.Struct:
    return T.Struct(f"TrainExample{seq_len}", [
        T.Field("doc_id", T.UUID),
        T.Field("tokens", T.FixedArray(T.UINT32, seq_len + 1)),
    ])


def example_layout(seq_len: int) -> DeviceLayout:
    return plan_device_layout(train_example_struct(seq_len))


def pack_examples(seq_len: int, tokens: np.ndarray,
                  doc_ids: Optional[np.ndarray] = None) -> np.ndarray:
    """tokens: [N, seq_len+1] uint32 -> structured record array."""
    s = train_example_struct(seq_len)
    dt = fastwire.static_dtype(s)
    n = tokens.shape[0]
    recs = np.zeros(n, dtype=dt)
    if doc_ids is None:
        doc_ids = np.frombuffer(
            b"".join(_uuid.uuid4().bytes for _ in range(n)),
            dtype="u1").reshape(n, 16)
    recs["doc_id"] = doc_ids
    recs["tokens"] = tokens.astype("<u4")
    return recs


def write_example_pages(seq_len: int, tokens: np.ndarray, *,
                        records_per_page: int = 64,
                        first_record: int = 0,
                        compress: bool = False) -> bytes:
    """Pack a token matrix into consecutive pages."""
    s = train_example_struct(seq_len)
    recs = pack_examples(seq_len, tokens)
    out = []
    for i in range(0, len(recs), records_per_page):
        chunk = recs[i:i + records_per_page]
        out.append(pages.write_page(s.name, chunk,
                                    first_record=first_record + i,
                                    compress=compress))
    return b"".join(out)


def synthetic_corpus(seq_len: int, num_examples: int, vocab_size: int,
                     seed: int = 0) -> np.ndarray:
    """Zipf-ish synthetic token stream (deterministic)."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.2, size=(num_examples, seq_len + 1))
    return np.minimum(ranks, vocab_size - 1).astype("<u4")


def iter_example_batches(buf: bytes, seq_len: int, batch: int, *,
                         cursor: int = 0,
                         verify: bool = True
                         ) -> Iterator[Tuple[np.ndarray, int]]:
    """Host-side decode: yield ([batch, seq+1] i64 token matrices, cursor).

    ``cursor`` is a global record index (the paper's stream-cursor concept
    applied to data restart): iteration resumes exactly at that record.
    """
    s = train_example_struct(seq_len)
    start = pages.seek_cursor(buf, cursor)
    if start is None:
        return
    pending = []
    count = 0
    for off in pages.iter_pages(buf):
        if off < start:
            continue
        h = pages.read_header(buf, off)
        recs = pages.decode_page(s, buf, off, verify=verify)
        lo = max(cursor - h.first_record, 0)
        recs = recs[lo:]
        pending.append(recs["tokens"])
        count = h.first_record + h.record_count
        total = sum(len(p) for p in pending)
        while total >= batch:
            cat = np.concatenate(pending) if len(pending) > 1 else pending[0]
            yield cat[:batch].astype(np.int64), count - (total - batch)
            pending = [cat[batch:]] if total > batch else []
            total -= batch
