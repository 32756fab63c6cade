"""MurmurHash3 (x86_32) with the lowbias32 finalizer.

Copied from the JAX package's ``core/hashing.py``: page headers carry
``schema_hash(name)`` and RPC frames ``method_id(service, method)``, so both
packages must compute the same 32 bits.
"""
from __future__ import annotations

import struct as _struct

_M = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def lowbias32(x: int) -> int:
    """hash-prospector's lowbias32 finalizer (bias 0.17 vs fmix32's 0.23)."""
    x &= _M
    x ^= x >> 16
    x = (x * 0x21F0AAAD) & _M
    x ^= x >> 15
    x = (x * 0xD35A2D97) & _M
    x ^= x >> 15
    return x


def murmur3_lowbias32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 body with lowbias32 as the finalizer."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & _M
    nblocks = len(data) // 4
    for i in range(nblocks):
        k = _struct.unpack_from("<I", data, i * 4)[0]
        k = (k * c1) & _M
        k = _rotl32(k, 15)
        k = (k * c2) & _M
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _M
    tail = data[nblocks * 4:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & _M
        k = _rotl32(k, 15)
        k = (k * c2) & _M
        h ^= k
    h ^= len(data)
    return lowbias32(h)


def schema_hash(name: str) -> int:
    return murmur3_lowbias32(name.encode("utf-8"), seed=0x42454250)  # "BEBP"


def method_id(service: str, method: str) -> int:
    """Stable 32-bit routing ID for ``/ServiceName/MethodName``."""
    return murmur3_lowbias32(f"/{service}/{method}".encode("utf-8"))
