"""Share of the traced window in which no kernel or copy ran on the card:
1 - (union of the device's operation intervals / the window's wall time),
from ``torch.profiler``."""

LAYER = "Device: H100"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
