"""Record pages: a checksummed ``[record_count, record_stride]`` byte matrix.

Copied from the JAX package's ``core/pages.py`` (page write, header read,
payload validation, the host decode, page iteration and cursor seek), so
the port reads and writes the same bytes.

Page layout (all little-endian):

    offset  size  field
    0       4     magic          0x42454250 ("BEBP")
    4       2     version        1
    6       2     flags          bit0: payload is zstd-compressed
    8       4     record_count   u32
    12      4     record_stride  u32 bytes per record
    16      4     schema_hash    murmur3+lowbias32 of the schema name
    20      4     payload_crc32  zlib.crc32 of the (uncompressed) payload
    24      8     first_record   u64 global index of record 0
    32      4     payload_bytes  u32 stored payload byte count
    36      28    reserved (zero)
    64      ...   payload, zero-padded so total page size % 512 == 0
"""
from __future__ import annotations

import dataclasses
import struct as _struct
import zlib
from typing import Iterator, Optional

import numpy as np

from . import fastwire
from . import types as T
from .hashing import schema_hash

MAGIC = 0x42454250
VERSION = 1
HEADER_SIZE = 64
PAGE_ALIGN = 512
FLAG_COMPRESSED = 1

_HEADER = _struct.Struct("<IHHIIIIQI")


class PageError(T.BebopError):
    pass


@dataclasses.dataclass(frozen=True)
class PageHeader:
    record_count: int
    record_stride: int
    schema_hash: int
    payload_crc32: int
    first_record: int
    payload_bytes: int
    flags: int = 0

    @property
    def compressed(self) -> bool:
        return bool(self.flags & FLAG_COMPRESSED)


def _pad_to(n: int, align: int) -> int:
    return (n + align - 1) // align * align


def write_page(schema_name: str, records: np.ndarray, first_record: int = 0,
               *, compress: bool = False) -> bytes:
    """Pack a structured array (or [N, stride] u8 matrix) into one page."""
    if records.ndim == 1 and records.dtype.names:
        payload = np.ascontiguousarray(records).view("u1").reshape(
            len(records), records.dtype.itemsize)
    elif records.ndim == 2 and records.dtype == np.uint8:
        payload = np.ascontiguousarray(records)
    else:
        raise PageError(f"records must be structured or [N,stride] u8, "
                        f"got {records.dtype} ndim={records.ndim}")
    count, stride = payload.shape
    raw = payload.tobytes()
    crc = zlib.crc32(raw)
    flags = 0
    stored = raw
    if compress:
        import zstandard
        stored = zstandard.ZstdCompressor(level=3).compress(raw)
        flags |= FLAG_COMPRESSED
    header = _HEADER.pack(MAGIC, VERSION, flags, count, stride,
                          schema_hash(schema_name), crc, first_record,
                          len(stored))
    header += b"\x00" * (HEADER_SIZE - len(header))
    total = _pad_to(HEADER_SIZE + len(stored), PAGE_ALIGN)
    return header + stored + b"\x00" * (total - HEADER_SIZE - len(stored))


def page_size(header: PageHeader) -> int:
    return _pad_to(HEADER_SIZE + header.payload_bytes, PAGE_ALIGN)


def read_header(buf, offset: int = 0) -> PageHeader:
    if len(buf) - offset < HEADER_SIZE:
        raise PageError("truncated page header")
    (magic, version, flags, count, stride, shash, crc, first, stored
     ) = _HEADER.unpack_from(buf, offset)
    if magic != MAGIC:
        raise PageError(f"bad page magic {magic:#x}")
    if version != VERSION:
        raise PageError(f"unsupported page version {version}")
    return PageHeader(count, stride, shash, crc, first, stored, flags)


def read_payload(buf, offset: int = 0, *, verify: bool = True,
                 expect_schema: Optional[str] = None) -> np.ndarray:
    """Return the page payload as a zero-copy ``[count, stride]`` u8 view.

    (Compressed pages decompress first — one allocation, then a view.)
    """
    h = read_header(buf, offset)
    if expect_schema is not None and h.schema_hash != schema_hash(expect_schema):
        raise PageError(f"schema mismatch: page does not hold {expect_schema}")
    logical = h.record_count * h.record_stride
    if not h.compressed and h.payload_bytes != logical:
        raise PageError(
            f"payload size mismatch: header stores {h.payload_bytes} bytes "
            f"for {h.record_count}x{h.record_stride} records")
    start = offset + HEADER_SIZE
    stored = memoryview(buf)[start:start + h.payload_bytes]
    if len(stored) < h.payload_bytes:
        raise PageError("truncated page payload")
    if h.compressed:
        import zstandard
        raw: bytes = zstandard.ZstdDecompressor().decompress(
            bytes(stored), max_output_size=logical)
        if len(raw) != logical:
            raise PageError(
                f"decompressed payload is {len(raw)} bytes, header promises "
                f"{logical}")
    else:
        raw = stored  # type: ignore[assignment]
    if verify:
        if zlib.crc32(bytes(raw) if h.compressed else raw) != h.payload_crc32:
            raise PageError("payload CRC mismatch (corrupt page)")
    arr = np.frombuffer(raw, dtype="u1", count=logical)
    return arr.reshape(h.record_count, h.record_stride)


def decode_page(s: T.Struct, buf, offset: int = 0, *,
                verify: bool = True) -> np.ndarray:
    """Page -> structured record view (the branchless host decode)."""
    payload = read_payload(buf, offset, verify=verify, expect_schema=s.name)
    dt = fastwire.static_dtype(s)
    if dt is None:
        raise PageError(f"struct {s.name} has no static layout")
    h = read_header(buf, offset)
    if h.record_stride != dt.itemsize:
        raise PageError(
            f"stride mismatch: page {h.record_stride}, schema {dt.itemsize}")
    return np.ascontiguousarray(payload).view(dt).reshape(h.record_count)


def iter_pages(buf) -> Iterator[int]:
    """Yield byte offsets of consecutive pages in a buffer/file mapping."""
    off = 0
    n = len(buf)
    while off + HEADER_SIZE <= n:
        h = read_header(buf, off)
        yield off
        off += page_size(h)


def seek_cursor(buf, cursor: int) -> Optional[int]:
    """First page offset containing global record index >= cursor (§7.5)."""
    for off in iter_pages(buf):
        h = read_header(buf, off)
        if h.first_record + h.record_count > cursor:
            return off
    return None
