"""Spans: named, timed intervals of the served path, kept in memory.

A span is a name, a start and an end on ``time.monotonic_ns()``, the id
of its parent span (0: none), the request it served (0: none), the
thread that recorded it and a small dict of attributes, the counts at
that boundary.  The RPC server gives each call a request id; spans a
handler thread records carry it, and so do the spans the batcher's
worker records for a request submitted from that thread.

The recorder is off by default.  Every site tests :data:`on` before it
reads a clock or builds anything, so while it is off a site costs that
one test.  :func:`enable` turns it on with an empty ring of a bounded
size (the oldest spans fall out first); :func:`drain` turns it off and
hands over the spans, how many fell out, and one ``(monotonic_ns,
time_ns)`` pair read back to back, which maps the spans onto clocks on
Unix time such as ``torch.profiler``'s.  Nothing is written anywhere
while it runs.

    spans.enable()
    ...                                   # serve
    got = spans.drain()                   # {"spans", "dropped", "clock"}
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Iterator, NamedTuple, Optional

#: the recorder's switch: sites test it before anything else
on = False


class Span(NamedTuple):
    id: int
    name: str
    start: int      # time.monotonic_ns()
    end: int
    parent: int     # id of the span this one lies in; 0: none
    request: int    # the request it served; 0: none
    thread: str
    attrs: dict


_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=1)
_kept = 0           # spans recorded since enable(), guarded by _lock
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()   # .span, .request: this thread's open scope

now = time.monotonic_ns


def enable(capacity: int = 1 << 20) -> None:
    """Start recording into an empty ring that keeps the newest
    ``capacity`` spans."""
    global on, _ring, _kept
    with _lock:
        _ring = collections.deque(maxlen=capacity)
        _kept = 0
    on = True


def drain() -> dict:
    """Stop recording and hand over what was kept: ``spans`` (in the order
    they ended), ``dropped`` (how many fell out of the ring) and
    ``clock``, a ``(monotonic_ns, time_ns)`` pair read back to back."""
    global on, _ring, _kept
    on = False
    with _lock:
        got, _ring = list(_ring), collections.deque(maxlen=1)
        dropped, _kept = _kept - len(got), 0
    clock = (time.monotonic_ns(), time.time_ns())
    return {"spans": got, "dropped": dropped, "clock": clock}


def _keep(span: Span) -> None:
    """Into the ring; a span that ends after :func:`drain` is dropped."""
    global _kept
    with _lock:
        if on:
            _kept += 1
            _ring.append(span)


def new_request() -> int:
    return next(_requests)


def current_request() -> int:
    """The request id of the scope open on this thread (0: none)."""
    return getattr(_local, "request", 0)


def add(name: str, start: int, end: int = 0, *,
        parent: Optional[int] = None, request: Optional[int] = None,
        **attrs) -> int:
    """Record a span that has ended (at ``end``, or now); by default it
    lies in this thread's open scope and serves its request.  Returns its
    id."""
    sid = next(_ids)
    _keep(Span(sid, name, start, end or now(),
               getattr(_local, "span", 0) if parent is None else parent,
               current_request() if request is None else request,
               threading.current_thread().name, attrs))
    return sid


@contextlib.contextmanager
def scope(name: str, request: int = 0, **attrs) -> Iterator[int]:
    """Record ``name`` around the body: spans this thread adds meanwhile
    lie in it and serve ``request`` (by default the enclosing scope's)."""
    loc = _local
    parent, outer = getattr(loc, "span", 0), current_request()
    sid, request = next(_ids), request or outer
    loc.span, loc.request = sid, request
    start = now()
    try:
        yield sid
    finally:
        loc.span, loc.request = parent, outer
        _keep(Span(sid, name, start, now(), parent, request,
                   threading.current_thread().name, attrs))
