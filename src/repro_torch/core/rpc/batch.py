"""Batch pipelining (§7.3): N dependent calls in one round trip.

Copied unchanged from the JAX package's ``core/rpc/batch.py``: it is JAX-free
host code, and both packages must put the same bytes on the wire.

Each call carries ``input_from``: -1 means "use my own payload", k >= 0 means
"forward call k's result as my input".  The server builds the dependency
graph, partitions it into execution layers, and runs each layer's calls
concurrently — layer k+1 waits only for what it depends on.

Failure semantics (§7.3):
  * a failed call fails all transitive dependents with INVALID_ARGUMENT
  * deadline expiry mid-batch fails remaining calls with DEADLINE_EXCEEDED
  * server-stream methods buffer their frames into the ``stream`` array
  * client-stream / duplex methods are rejected (INVALID_ARGUMENT)
"""
from __future__ import annotations

import concurrent.futures as _cf
from typing import Callable, Dict, List, Optional, Sequence

from .deadline import Deadline
from .status import RpcError, Status

# handler signature the router provides:
#   invoke(method_id, payload, ctx) -> bytes | list[bytes] (server-stream)
Invoker = Callable[[int, bytes, object], object]


def build_layers(calls: Sequence[dict]) -> List[List[int]]:
    """Partition call indices into dependency layers; validates the graph."""
    n = len(calls)
    deps: List[Optional[int]] = []
    for i, c in enumerate(calls):
        src = c.get("input_from", -1)
        if src == -1:
            deps.append(None)
        else:
            if not (0 <= src < n):
                raise RpcError(Status.INVALID_ARGUMENT,
                               f"call {i}: input_from {src} out of range")
            if src >= i:
                raise RpcError(Status.INVALID_ARGUMENT,
                               f"call {i}: input_from {src} must reference an "
                               f"earlier call")
            deps.append(src)
    depth = [0] * n
    for i, d in enumerate(deps):
        if d is not None:
            depth[i] = depth[d] + 1
    layers: Dict[int, List[int]] = {}
    for i, dep in enumerate(depth):
        layers.setdefault(dep, []).append(i)
    return [layers[k] for k in sorted(layers)]


def execute_batch(calls: Sequence[dict], invoke: Invoker, *,
                  deadline: Optional[Deadline] = None,
                  ctx=None,
                  executor: Optional[_cf.Executor] = None,
                  method_kinds: Optional[Dict[int, str]] = None) -> List[dict]:
    """Run a batch; returns one BatchCallResult dict per call (in order)."""
    n = len(calls)
    results: List[dict] = [{} for _ in range(n)]
    outputs: List[Optional[bytes]] = [None] * n
    failed = [False] * n

    # pre-validate method kinds
    kinds = method_kinds or {}
    for i, c in enumerate(calls):
        kind = kinds.get(c.get("method_id"), "unary")
        if kind in ("client_stream", "duplex"):
            results[i] = {"call_id": c.get("call_id", i),
                          "status": Status.INVALID_ARGUMENT,
                          "error": f"{kind} methods cannot be batched"}
            failed[i] = True

    try:
        layers = build_layers(calls)
    except RpcError as e:
        return [{"call_id": c.get("call_id", i), "status": e.code,
                 "error": e.message} for i, c in enumerate(calls)]

    own_pool = executor is None
    pool = executor or _cf.ThreadPoolExecutor(max_workers=max(4, n))
    try:
        for layer in layers:
            if deadline is not None and deadline.expired():
                for i in layer:
                    if not results[i]:
                        results[i] = {
                            "call_id": calls[i].get("call_id", i),
                            "status": Status.DEADLINE_EXCEEDED,
                            "error": "batch deadline expired mid-execution"}
                        failed[i] = True
                continue
            futs = {}
            for i in layer:
                if failed[i] or results[i]:
                    continue
                c = calls[i]
                src = c.get("input_from", -1)
                if src >= 0 and failed[src]:
                    results[i] = {
                        "call_id": c.get("call_id", i),
                        "status": Status.INVALID_ARGUMENT,
                        "error": f"dependency call {src} failed"}
                    failed[i] = True
                    continue
                payload = bytes(c.get("payload", b"")) if src == -1 \
                    else outputs[src]
                futs[pool.submit(_run_one, invoke, c, payload, ctx,
                                 kinds.get(c.get("method_id"), "unary"))] = i
            for fut in _cf.as_completed(futs):
                i = futs[fut]
                res, out = fut.result()
                results[i] = res
                outputs[i] = out
                failed[i] = res["status"] != Status.OK
        # anything untouched (shouldn't happen) -> INTERNAL
        for i in range(n):
            if not results[i]:
                results[i] = {"call_id": calls[i].get("call_id", i),
                              "status": Status.INTERNAL,
                              "error": "call never executed"}
        return results
    finally:
        if own_pool:
            pool.shutdown(wait=False)


def _run_one(invoke: Invoker, call: dict, payload: bytes, ctx, kind: str):
    call_id = call.get("call_id", 0)
    try:
        out = invoke(call["method_id"], payload, ctx)
        if kind == "server_stream":
            # buffer stream results into an array (§7.3)
            items = [bytes(x) for x in out]
            return ({"call_id": call_id, "status": Status.OK,
                     "stream": items}, items[-1] if items else b"")
        out = bytes(out) if out is not None else b""
        return ({"call_id": call_id, "status": Status.OK,
                 "payload": out}, out)
    except RpcError as e:
        return ({"call_id": call_id, "status": e.code,
                 "error": e.message}, None)
    except Exception as e:  # noqa: BLE001 — handler fault -> INTERNAL
        return ({"call_id": call_id, "status": Status.INTERNAL,
                 "error": str(e)}, None)
