"""The PowerSGD kernels' share of their roofline: the least time of the
step's compression work (``bench.flops.powersgd_work`` over the cell's
shape groups: fp32 operations at 67 TFLOP/s against the bytes at 3.35
TB/s, the larger) over the device time of the kernels named below in the
traced window, a step."""
import re

from bench import flops

UNIT, LAYER, MOVES = "%", "kernels", "tokens_per_s"
#: the kernels of src/repro_torch/kernels/csrc/lowrank.cu
KERNELS = re.compile(r"ef_factor_kernel|split_sum_kernel|decompress_kernel"
                     r"|gram_schmidt_kernel")


def read(rec):
    cap = rec.captured
    if cap is None or not cap.steps:
        return None
    us = sum(k.end - k.start for k in cap.kernels if KERNELS.search(k.name))
    if us <= 0:
        return None
    work = flops.powersgd_work(rec.groups, rec.param_bytes, rec.world)
    return 100.0 * flops.least_seconds(*work) / (us / 1e6 / cap.steps)
