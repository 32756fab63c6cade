"""The whole window's share of the chip's peak: the least time the chip
needs for the window's useful work, over the window's wall time.  The
work: each generated token (its products in the layers, its attention
over its context, its row of logits) and each prompt token prefilled
(its products in the layers; the prefix cache's reused tokens left out),
against the bf16 peak; the weights read once a step and each decoding
row's K/V once a step, against the HBM rate.  Counted by
``perfbench/roofline``."""

import roofline as R

LAYER = "Model step: models/transformer.py, models/moe.py"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return R.serve_step_mfu(rec)
