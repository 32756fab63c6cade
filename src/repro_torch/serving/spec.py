"""Self-speculative drafting: n-gram lookup over a request's own tokens.

Copied from the JAX package's ``serving/spec.py`` (numpy only): a cheap
drafter proposes continuation tokens from the request's own history and
one verify step scores them all; for greedy requests the verifier's
argmax is authoritative, so emitted tokens are bit-identical to plain
greedy decode.
"""
from __future__ import annotations

import numpy as np

_EMPTY = np.zeros(0, np.int32)


def ngram_propose(history, max_len: int, *, min_n: int = 2,
                  max_n: int = 4) -> np.ndarray:
    """Propose up to ``max_len`` continuation tokens for ``history``.

    Finds the longest suffix n-gram (``max_n`` down to ``min_n`` tokens)
    of ``history`` that also occurs earlier in it, takes the MOST RECENT
    such occurrence, and returns the tokens that followed it.  Returns an
    empty array when nothing matches — the scheduler then falls back to
    the plain one-token decode step, so drafting can never hurt
    correctness and a non-repetitive request only pays this lookup.

    ``min_n >= 2`` by default: on random-ish text a 1-token match is
    nearly always present but nearly never predictive, and every
    no-accept verify step costs a full chunk-wide model call.
    """
    h = np.asarray(history, np.int32).reshape(-1)
    t = h.shape[0]
    if max_len <= 0 or t < min_n + 1:
        return _EMPTY
    max_n = max(max_n, min_n)   # min_n above the ceiling still gets tried
    for n in range(min(max_n, t - 1), min_n - 1, -1):
        pattern = h[t - n:]
        # all length-n windows starting strictly before the suffix itself
        # (start < t - n also guarantees at least one continuation token)
        windows = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        hits = np.nonzero((windows == pattern).all(axis=1))[0]
        if hits.size == 0:
            continue
        # most recent occurrence wins — but on periodic text (the greedy
        # cycles this drafter exists for) the newest match sits right at
        # the end of history with almost nothing after it, so prefer the
        # newest match that still has a FULL max_len continuation
        full = hits[hits + n + max_len <= t]
        start = int(full[-1]) if full.size else int(hits[-1])
        return h[start + n:start + n + max_len].copy()
    return _EMPTY
