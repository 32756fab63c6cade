"""The decode kernel's share of its roofline over the traced window
(``kernels/csrc/paged_attention.cu``, its decode instantiation): the
bytes the window's decode rows in plain decode steps need (each row's
query and output once, K and V of its context once, every layer) at the
HBM rate, over the kernel's summed device time in the trace.

Which steps were plain decode steps is read from the token stamps: the
tokens one step emits carry stamps within a millisecond, so each burst
of stamps is a step, and a step is a plain decode step when no request
was prefilling through it (submitted before the step began, its first
token not yet out).  The cell's server runs without speculative decode,
so a plain decode step is exactly a launch of this kernel a layer."""

import roofline as R

LAYER = "Kernels: kernels/csrc/paged_attention.cu"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(rec):
    tr = rec.get("trace")
    if not tr or rec.get("kind") != "serve" or rec["server"].get(
            "spec_decode", True) or not tr["kernels"]["paged_decode"]:
        return None
    need = R.decode_kernel_bytes(rec, tr["start"], tr["stop"])
    if not need:
        return None
    return 100.0 * need / R.PEAK_BYTES_PER_S / tr["kernels"]["paged_decode"]
