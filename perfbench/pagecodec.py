"""The benchmark's own frozen copy of the Bebop page format.

A page is a 64-byte header and a ``[record_count, record_stride]`` payload
of fixed-layout records, padded to a multiple of 512 bytes; the header
names the record struct by a 32-bit hash of its name and carries the
payload's CRC-32.  Prompt pages hold ``PromptRecord{T} { tokens: u32[T] }``,
response pages ``GenRecord{N} { tokens: u32[N] }``.

The benchmark encodes every page it sends and decodes every page it gets
back with this module alone, so a change to the program's encoder cannot
change what the benchmark feeds or how it reads the answer.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 0x42454250            # "BEBP"
VERSION = 1
HEADER_SIZE = 64
PAGE_ALIGN = 512
_HEADER = struct.Struct("<IHHIIIIQI")
_M = 0xFFFFFFFF


class PageFormatError(ValueError):
    """A page that does not hold what the benchmark expects."""


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def _lowbias32(x: int) -> int:
    x &= _M
    x ^= x >> 16
    x = (x * 0x21F0AAAD) & _M
    x ^= x >> 15
    x = (x * 0xD35A2D97) & _M
    x ^= x >> 15
    return x


def _murmur3_lowbias32(data: bytes, seed: int) -> int:
    """MurmurHash3 x86_32 with the lowbias32 finalizer."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & _M
    n = len(data) // 4
    for i in range(n):
        k = struct.unpack_from("<I", data, i * 4)[0]
        k = _rotl32((k * c1) & _M, 15)
        h ^= (k * c2) & _M
        h = (_rotl32(h, 13) * 5 + 0xE6546B64) & _M
    tail = data[n * 4:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if tail:
        k ^= tail[0]
        k = _rotl32((k * c1) & _M, 15)
        h ^= (k * c2) & _M
    h ^= len(data)
    return _lowbias32(h)


def schema_hash(name: str) -> int:
    return _murmur3_lowbias32(name.encode("utf-8"), seed=MAGIC)


def write_page(schema_name: str, payload: np.ndarray) -> bytes:
    """One uncompressed page of a ``[count, stride]`` uint8 payload."""
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    count, stride = payload.shape
    raw = payload.tobytes()
    header = _HEADER.pack(MAGIC, VERSION, 0, count, stride,
                          schema_hash(schema_name), zlib.crc32(raw), 0,
                          len(raw))
    header += b"\x00" * (HEADER_SIZE - len(header))
    total = -(-(HEADER_SIZE + len(raw)) // PAGE_ALIGN) * PAGE_ALIGN
    return header + raw + b"\x00" * (total - HEADER_SIZE - len(raw))


def read_payload(buf, schema_name: str) -> np.ndarray:
    """The ``[count, stride]`` uint8 payload of a page of ``schema_name``,
    its header and CRC checked."""
    buf = bytes(buf)
    if len(buf) < HEADER_SIZE:
        raise PageFormatError("truncated page header")
    magic, version, flags, count, stride, shash, crc, _, stored = \
        _HEADER.unpack_from(buf, 0)
    if magic != MAGIC or version != VERSION or flags:
        raise PageFormatError(f"not a plain version-1 page: magic "
                              f"{magic:#x}, version {version}, flags {flags}")
    if shash != schema_hash(schema_name):
        raise PageFormatError(f"page does not hold {schema_name}")
    if stored != count * stride or len(buf) < HEADER_SIZE + stored:
        raise PageFormatError("payload size mismatch")
    raw = buf[HEADER_SIZE:HEADER_SIZE + stored]
    if zlib.crc32(raw) != crc:
        raise PageFormatError("payload CRC mismatch")
    return np.frombuffer(raw, np.uint8).reshape(count, stride)


def prompt_page(tokens: np.ndarray) -> bytes:
    """``[B, T]`` token ids -> a page of ``PromptRecord{T}``."""
    tokens = np.atleast_2d(np.asarray(tokens))
    u32 = np.ascontiguousarray(tokens, dtype="<u4")
    return write_page(f"PromptRecord{tokens.shape[1]}",
                      u32.view(np.uint8).reshape(tokens.shape[0], -1))


def gen_tokens(buf, new_tokens: int) -> np.ndarray:
    """A page of ``GenRecord{new_tokens}`` -> ``[B, new_tokens]`` int64."""
    payload = read_payload(buf, f"GenRecord{new_tokens}")
    if payload.shape[1] != 4 * new_tokens:
        raise PageFormatError(f"stride {payload.shape[1]} for "
                              f"{new_tokens} tokens")
    return np.ascontiguousarray(payload).view("<u4").astype(np.int64)

