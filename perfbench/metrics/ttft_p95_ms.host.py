"""The 95th percentile of time to first token over the requests due in
the window, from the due time to the first token stamped by the
batcher's ``on_token`` hook; a request that failed or gave no first
token counts as waiting until the drain gave up.  In a cell whose host
paces the steps and whose load is past the knee it swings with the
smallest change, so it is recorded here and not judged."""

LAYER = "Service: serving/service.py Infer, end to end"
UNIT = "ms"
MOVES = "serve_tokens_per_s"


def read(rec):
    return rec.get("e2e", {}).get("ttft_p95_ms")
