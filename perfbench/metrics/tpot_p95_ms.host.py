"""The 95th percentile of the time between output tokens over the requests
of the window that gave more than one: (last token - first token) /
(tokens - 1), stamped by the batcher's ``on_token`` hook.  In a
cell whose host paces the steps and whose load is past the knee it
swings with the smallest change, so it is recorded here and not judged."""

LAYER = "Service: serving/service.py Infer, end to end"
UNIT = "ms"
MOVES = "serve_tokens_per_s"


def read(rec):
    return rec.get("e2e", {}).get("tpot_p95_ms")
