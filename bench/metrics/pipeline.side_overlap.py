"""The overlapped sync's share of side-stream kernel time that ran while
a compute-stream kernel ran (the compute stream: the one with the most
kernel time) in the traced window."""
from bench import trace

UNIT, LAYER, MOVES = "%", "pipeline executor", "tokens_per_s"


def read(rec):
    cap = rec.captured
    if cap is None:
        return None
    got = trace.side_overlap(cap.kernels)
    if got is None or got[0] <= 0:
        return None
    return 100.0 * got[1] / got[0]
