"""Share of the prompt tokens submitted in the window that the prefix
cache served: the batcher's ``prefix_tokens_reused`` counter over the
window, against the prompt tokens of the requests submitted in it."""

LAYER = "Scheduler: serving/engine.py PagedBatcher"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(rec):
    if rec.get("kind") != "serve" or not rec["prompt_tokens_submitted"]:
        return None
    reused = rec["stats1"]["prefix_tokens_reused"] \
        - rec["stats0"]["prefix_tokens_reused"]
    return 100.0 * reused / rec["prompt_tokens_submitted"]
