"""The device's idle share of the traced window: 1 - (the union of every
kernel's interval, on every stream) / the window's length."""
from bench import trace

UNIT, LAYER, MOVES = "%", "device", "tokens_per_s"


def read(rec):
    cap = rec.captured
    if cap is None or not cap.kernels or cap.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us(cap) / cap.window_us)
