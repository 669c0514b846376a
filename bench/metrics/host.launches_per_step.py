"""Kernel launches a step: the CUDA runtime's launch calls in the traced
window over its steps."""
UNIT, LAYER, MOVES = "launches/step", "host loop", "tokens_per_s"


def read(rec):
    cap = rec.captured
    if cap is None or not cap.steps or not cap.launches:
        return None
    return cap.launches / cap.steps
