"""Histogram counts for the GDS entropy estimator on Hopper, with the plain
version.

The CUDA C++ lives in ``csrc/entropy_hist.cu`` (built by ``build.py``,
loaded with ``ctypes``). ``hist_counts`` replaces
``repro/kernels/entropy_hist.py:37 hist_counts`` (``_hist_kernel``): the
bin of x is ``(x - lo) * inv_width`` in fp32, truncated toward zero and
clipped to ``[0, num_bins - 1]``. ``ops.sampled_entropy_hist`` computes
(lo, inv_width) from the sample's moments and the entropy from the counts.

Design (H100 SXM: 3.35 TB/s HBM): one read of x, bound by bytes. Each
warp counts into its own shared-memory histogram, blocks add their
integer sums into the output, and the wrapper converts to fp32 once. The
ragged tail is masked in the kernel, so no sentinel padding is needed (the
reference padded and subtracted the pad from bin 0), and integer counts
stay exact beyond 2**24 per bin, where the reference's fp32 sums would not.

A wrapper given CPU tensors runs its plain version (``ref.py``); given
CUDA tensors it launches its kernel or raises. ``<wrapper>.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .launch import launch
from .launch import on_cpu as _on_cpu
from .launch import ptr as _ptr

__all__ = ["hist_counts", "KERNELS", "MAX_BINS"]

F32 = torch.float32
#: Most bins the kernel's shared-memory histograms hold.
MAX_BINS = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = build.load("entropy_hist")
    if not getattr(lib, "_typed", False):
        lib.repro_hist_counts.argtypes = [_P, ctypes.c_longlong, _P, _P,
                                          ctypes.c_int, ctypes.c_int, _P]
        lib.repro_hist_counts.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _scalar(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=F32, device=device).reshape(())


def hist_counts(x, lo, inv_width, *, num_bins: int = 256):
    """Counts (num_bins,) fp32 of flat x (N,), given ``lo`` and
    ``inv_width`` = 1 / bin width (floats or 0-d tensors, taken as fp32)."""
    scal = torch.stack([_scalar(lo, x.device), _scalar(inv_width, x.device)])
    if _on_cpu(x, scal):
        return ref.hist_counts(x, scal[0], scal[1], num_bins)
    if x.ndim != 1 or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"want a flat fp32/bf16/fp16 sample, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins={num_bins}: the kernel takes 1..{MAX_BINS}")
    x = x.contiguous()
    counts = torch.zeros(num_bins, dtype=torch.int64, device=x.device)
    if x.numel():
        launch(_lib(), hist_counts, "repro_hist_counts", x.device, _ptr(x),
               x.numel(), _ptr(scal), _ptr(counts), num_bins,
               _DTYPE_CODE[x.dtype])
    return counts.to(F32)


#: The kernels of this module: launch counters live on these wrappers.
KERNELS = (hist_counts,)
hist_counts.launches = 0
