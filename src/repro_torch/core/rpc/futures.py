"""Push-based futures (§7.6): dispatch / resolve-stream / cancel.

Copied unchanged from the JAX package's ``core/rpc/futures.py``: it is JAX-free
host code, and both packages must put the same bytes on the wire.

A FutureDispatchRequest wraps a unary call (or batch) for background
execution; the server returns a FutureHandle immediately and pushes a
FutureResult on the resolve stream when the work completes — no polling.

Implemented per the paper:
  * idempotency keys, scoped per caller (§7.6.1)
  * caller-identity ownership; foreign resolve/cancel -> PERMISSION_DENIED
  * retention policy (eviction-by-count default) + ``discard_result`` opt-out
  * the storage protocol splits persist vs notify so a database backend can
    commit before fanning out to in-memory streams (§7.6.2)
"""
from __future__ import annotations

import queue
import threading
import uuid as _uuid
from typing import Callable, Dict, List, Optional, Tuple

from .deadline import Deadline
from .status import RpcError, Status


class FutureStorage:
    """Async storage protocol (§7.6.2).

    Persisting a completed result and notifying subscribers are separate
    methods so a durable backend can commit before fan-out.
    """

    def persist(self, owner: str, future_id: _uuid.UUID, result: dict) -> None:
        raise NotImplementedError

    def fetch(self, future_id: _uuid.UUID) -> Optional[dict]:
        raise NotImplementedError

    def evict(self, future_id: _uuid.UUID) -> None:
        raise NotImplementedError

    def completed_ids(self, owner: str) -> List[_uuid.UUID]:
        raise NotImplementedError


class InMemoryFutureStorage(FutureStorage):
    """Default store with eviction-by-count retention."""

    def __init__(self, max_completed: int = 1024):
        self.max_completed = max_completed
        self._lock = threading.Lock()
        self._results: Dict[_uuid.UUID, Tuple[str, dict]] = {}
        self._order: List[_uuid.UUID] = []

    def persist(self, owner, future_id, result):
        with self._lock:
            self._results[future_id] = (owner, result)
            self._order.append(future_id)
            while len(self._order) > self.max_completed:
                old = self._order.pop(0)
                self._results.pop(old, None)

    def fetch(self, future_id):
        with self._lock:
            ent = self._results.get(future_id)
            return ent[1] if ent else None

    def evict(self, future_id):
        with self._lock:
            self._results.pop(future_id, None)
            try:
                self._order.remove(future_id)
            except ValueError:
                pass

    def completed_ids(self, owner):
        with self._lock:
            return [fid for fid, (o, _) in self._results.items() if o == owner]


class _Pending:
    __slots__ = ("owner", "key", "discard", "cancelled", "thread")

    def __init__(self, owner: str, key: Optional[_uuid.UUID], discard: bool):
        self.owner = owner
        self.key = key
        self.discard = discard
        self.cancelled = False
        self.thread: Optional[threading.Thread] = None


class FutureManager:
    """Server-side future registry + resolve-stream fan-out."""

    def __init__(self, storage: Optional[FutureStorage] = None,
                 rng: Optional[Callable[[], _uuid.UUID]] = None):
        self.storage = storage or InMemoryFutureStorage()
        self._rng = rng or _uuid.uuid4
        self._lock = threading.Lock()
        self._pending: Dict[_uuid.UUID, _Pending] = {}
        # (owner, idempotency_key) -> future_id
        self._keys: Dict[Tuple[str, _uuid.UUID], _uuid.UUID] = {}
        # owner -> list of subscriber queues (ids filter, queue)
        self._subs: Dict[str, List[Tuple[Optional[set], queue.Queue]]] = {}

    # -- dispatch (§7.6, method id 2) ---------------------------------------
    def dispatch(self, owner: str, run: Callable[[], bytes], *,
                 idempotency_key: Optional[_uuid.UUID] = None,
                 deadline: Optional[Deadline] = None,
                 discard_result: bool = False) -> Tuple[_uuid.UUID, bool]:
        """Register + start background work.  Returns (id, existing)."""
        with self._lock:
            if idempotency_key is not None:
                existing = self._keys.get((owner, idempotency_key))
                if existing is not None:
                    # pending or completed with the same key -> same handle
                    if existing in self._pending \
                            or self.storage.fetch(existing) is not None:
                        return existing, True
                    del self._keys[(owner, idempotency_key)]
            fid = self._rng()
            pend = _Pending(owner, idempotency_key, discard_result)
            self._pending[fid] = pend
            if idempotency_key is not None:
                self._keys[(owner, idempotency_key)] = fid

        def work():
            try:
                if deadline is not None and deadline.expired():
                    raise RpcError(Status.DEADLINE_EXCEEDED,
                                   "future deadline expired before start")
                payload = run()
                result = {"id": fid, "status": Status.OK,
                          "payload": payload or b""}
            except RpcError as e:
                result = {"id": fid, "status": e.code, "error": e.message}
            except Exception as e:  # noqa: BLE001
                result = {"id": fid, "status": Status.INTERNAL,
                          "error": str(e)}
            self._complete(fid, result)

        t = threading.Thread(target=work, daemon=True,
                             name=f"future-{str(fid)[:8]}")
        pend.thread = t
        t.start()
        return fid, False

    def _complete(self, fid: _uuid.UUID, result: dict) -> None:
        with self._lock:
            pend = self._pending.pop(fid, None)
            if pend is None:
                return
            if pend.cancelled:
                result = {"id": fid, "status": Status.CANCELLED,
                          "error": "cancelled"}
            # persist BEFORE notify (§7.6.2) unless discard_result
            if not pend.discard:
                self.storage.persist(pend.owner, fid, result)
            subs = list(self._subs.get(pend.owner, ()))
        for ids, q in subs:
            if ids is None or fid in ids:
                q.put(result)

    # -- resolve (§7.6, method id 3: server-stream) --------------------------
    def resolve(self, owner: str, ids: Optional[List[_uuid.UUID]] = None):
        """Yield FutureResult dicts for this owner's futures (blocking).

        Already-completed requested futures are sent immediately, then live
        completions stream until all requested ids resolved (or forever for
        a subscribe-to-all stream).
        """
        want: Optional[set] = set(ids) if ids else None
        q: queue.Queue = queue.Queue()
        with self._lock:
            # ownership check for explicitly requested ids
            if want is not None:
                for fid in want:
                    pend = self._pending.get(fid)
                    if pend is not None and pend.owner != owner:
                        raise RpcError(Status.PERMISSION_DENIED,
                                       f"future {fid} not owned by caller")
            self._subs.setdefault(owner, []).append((want, q))
            # replay already-completed results (§7.6: immediate send)
            ready = []
            if want is not None:
                for fid in list(want):
                    res = self.storage.fetch(fid)
                    if res is not None:
                        ready.append(res)
            else:
                for fid in self.storage.completed_ids(owner):
                    res = self.storage.fetch(fid)
                    if res is not None:
                        ready.append(res)
        try:
            outstanding = set(want) if want is not None else None
            for res in ready:
                yield res
                if outstanding is not None:
                    outstanding.discard(res["id"])
            if outstanding is not None and not outstanding:
                return
            while True:
                res = q.get()
                if res is None:  # shutdown sentinel
                    return
                yield res
                if outstanding is not None:
                    outstanding.discard(res["id"])
                    if not outstanding:
                        return
        finally:
            with self._lock:
                subs = self._subs.get(owner, [])
                self._subs[owner] = [(w, qq) for (w, qq) in subs if qq is not q]

    # -- cancel (§7.6, method id 4) ------------------------------------------
    def cancel(self, owner: str, fid: _uuid.UUID) -> None:
        with self._lock:
            pend = self._pending.get(fid)
            if pend is not None:
                if pend.owner != owner:
                    raise RpcError(Status.PERMISSION_DENIED,
                                   f"future {fid} not owned by caller")
                pend.cancelled = True
                # release the idempotency key (§7.6.1)
                if pend.key is not None:
                    self._keys.pop((owner, pend.key), None)
                return
        # completed: ownership check against storage, then evict
        res = self.storage.fetch(fid)
        if res is None:
            raise RpcError(Status.NOT_FOUND, f"unknown future {fid}")
        self.storage.evict(fid)

    def shutdown(self) -> None:
        with self._lock:
            for subs in self._subs.values():
                for _, q in subs:
                    q.put(None)
