"""Decode rows a decoding step carried, on average over the window: the
batcher's ``batched_rows`` over its ``decode_steps`` (mixed, verify and
plain decode steps that advanced at least one decoding row)."""

LAYER = "Scheduler: serving/engine.py PagedBatcher"
UNIT = "rows"
MOVES = "serve_tokens_per_s"


def read(rec):
    if rec.get("kind") != "serve":
        return None
    steps = rec["stats1"]["decode_steps"] - rec["stats0"]["decode_steps"]
    rows = rec["stats1"]["batched_rows"] - rec["stats0"]["batched_rows"]
    return rows / steps if steps else None
