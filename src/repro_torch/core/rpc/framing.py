"""Frame layer (§7.2, §7.5): fixed 9-byte header + optional cursor trailer.

Copied unchanged from the JAX package's ``core/rpc/framing.py``: it is JAX-free
host code, and both packages must put the same bytes on the wire.

    | length: u32 | flags: u8 | stream_id: u32 |  payload  [cursor: u64]

`length` counts ONLY payload bytes.  When the CURSOR flag (0x10) is set,
8 bytes of little-endian uint64 follow the payload, outside `length`
(§7.5).  A complete unary RPC is 18 bytes of framing overhead — one header
in each direction.
"""
from __future__ import annotations

import dataclasses
import struct as _struct
from typing import Iterator, List, Optional

from ..types import DecodeError

HEADER = _struct.Struct("<IBI")
HEADER_SIZE = 9
CURSOR_SIZE = 8

# A byte stream that desyncs (truncated or corrupted frame) starts
# producing garbage headers.  There is no per-frame checksum — payload
# integrity is the transport's job (TCP/TLS), exactly as in the paper's
# protocol — but a header whose length or flags are impossible is
# detectable immediately, and the connection that produced it is
# poisoned: the reader raises FramingError and the endpoint tears the
# connection down rather than guessing where the next frame starts.
MAX_FRAME_PAYLOAD = 1 << 26          # 64 MiB: far above any legit frame
KNOWN_FLAGS_MASK = 0x1F


class FramingError(DecodeError):
    """The byte stream does not parse as frames; the connection is dead."""


class Flags:
    END_STREAM = 0x01
    ERROR = 0x02
    COMPRESSED = 0x04
    TRAILER = 0x08
    CURSOR = 0x10


@dataclasses.dataclass(frozen=True)
class Frame:
    stream_id: int
    payload: bytes = b""
    flags: int = 0
    cursor: Optional[int] = None  # set iff Flags.CURSOR

    @property
    def end_stream(self) -> bool:
        return bool(self.flags & Flags.END_STREAM)

    @property
    def error(self) -> bool:
        return bool(self.flags & Flags.ERROR)


def encode_frame(f: Frame) -> bytes:
    flags = f.flags
    cursor_bytes = b""
    if f.cursor is not None:
        flags |= Flags.CURSOR
        cursor_bytes = _struct.pack("<Q", f.cursor)
    elif flags & Flags.CURSOR:
        raise ValueError("CURSOR flag set but no cursor value")
    return HEADER.pack(len(f.payload), flags, f.stream_id) + f.payload \
        + cursor_bytes


class FrameReader:
    """Incremental frame parser over a byte stream (any transport)."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Frame]:
        self._buf += data
        out: List[Frame] = []
        while True:
            f = self._try_parse()
            if f is None:
                return out
            out.append(f)

    def _try_parse(self) -> Optional[Frame]:
        if len(self._buf) < HEADER_SIZE:
            return None
        length, flags, stream_id = HEADER.unpack_from(self._buf, 0)
        if length > MAX_FRAME_PAYLOAD:
            raise FramingError(
                f"frame length {length} exceeds {MAX_FRAME_PAYLOAD} "
                f"(desynced or corrupted stream)")
        if flags & ~KNOWN_FLAGS_MASK:
            raise FramingError(
                f"unknown frame flags {flags:#04x} "
                f"(desynced or corrupted stream)")
        total = HEADER_SIZE + length
        cursor = None
        if flags & Flags.CURSOR:
            total += CURSOR_SIZE
        if len(self._buf) < total:
            return None
        payload = bytes(self._buf[HEADER_SIZE:HEADER_SIZE + length])
        if flags & Flags.CURSOR:
            cursor = _struct.unpack_from(
                "<Q", self._buf, HEADER_SIZE + length)[0]
        del self._buf[:total]
        return Frame(stream_id, payload, flags & ~Flags.CURSOR, cursor)

    def pending(self) -> int:
        return len(self._buf)


def frames_from_bytes(data: bytes) -> Iterator[Frame]:
    r = FrameReader()
    for f in r.feed(data):
        yield f
    if r.pending():
        raise DecodeError(f"{r.pending()} trailing bytes after last frame")
