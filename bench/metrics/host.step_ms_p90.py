"""The 90th percentile of the window's step intervals on the device's
timeline: CUDA events recorded as ``Trainer.run`` takes each batch, read
after the window (no synchronise inside it). Flush and entropy steps show
here."""
from bench import trace

UNIT, LAYER, MOVES = "ms", "host loop", "tokens_per_s"


def read(rec):
    if len(rec.step_ms) < 2:
        return None
    return trace.percentile(rec.step_ms, 90)
