"""Static record layouts: the packed numpy dtype of a fixed-width type.

Copied from the JAX package's ``core/fastwire.py``, trimmed to
:func:`static_dtype`, which the page codecs (``serving/service.py``) and the
device layout planner (``core/device.py``) use: a struct made only of
fixed-width fields has a static layout, so a page of N records is one
``np.frombuffer`` with this dtype, and encoding one is a structured-array
fill.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import types as T

_TIMESTAMP_DT = np.dtype([("sec", "<i8"), ("ns", "<i4"), ("offset_ms", "<i4")])
_DURATION_DT = np.dtype([("sec", "<i8"), ("ns", "<i4")])


def _prim_dtype(p: T.Prim) -> np.dtype:
    if p.name == "uuid":
        return np.dtype(("u1", (16,)))
    if p.name in ("int128", "uint128"):
        return np.dtype(("u1", (16,)))
    if p.name == "timestamp":
        return _TIMESTAMP_DT
    if p.name == "duration":
        return _DURATION_DT
    assert p.np_dtype is not None
    return p.np_dtype


def static_dtype(t: T.Type) -> Optional[np.dtype]:
    """Packed little-endian numpy dtype for a fixed-width type, else None.

    The returned dtype's itemsize equals the wire size exactly (no padding),
    so ``np.frombuffer(page, dtype=static_dtype(s))`` IS the decoder.
    """
    if isinstance(t, T.Enum):
        return t.base.np_dtype
    if isinstance(t, T.Prim):
        return _prim_dtype(t)
    if isinstance(t, T.FixedArray):
        ed = static_dtype(t.elem)
        if ed is None:
            return None
        return np.dtype((ed, (t.count,)))
    if isinstance(t, T.Struct):
        fields = []
        for f in t.fields:
            fd = static_dtype(f.type)
            if fd is None:
                return None
            fields.append((f.name, fd))
        dt = np.dtype(fields)
        assert dt.itemsize == t.static_size(), (dt.itemsize, t.static_size())
        return dt
    return None
