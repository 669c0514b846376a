"""Device milliseconds of NCCL kernels a step on rank 0, in the traced
window: the DP collectives' time on the card."""
UNIT, LAYER, MOVES = "ms", "DP collectives", "tokens_per_s"


def read(rec):
    cap = rec.captured
    if cap is None or not cap.steps:
        return None
    us = sum(k.end - k.start for k in cap.kernels if "nccl" in k.name.lower())
    if us <= 0:
        return None
    return us / 1e3 / cap.steps
