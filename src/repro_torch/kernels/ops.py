"""Kernel dispatch (port of ``repro/kernels/ops.py:23-164``).

The 2-D per-leaf forms run the batched kernels with E = 1. Unlike the
TPU's ``_tileable`` rule, the Hopper kernels mask ragged edges, so every
shape runs the kernel. The one routing rule kept is the reference's choice
of algorithm for orthonormalization: Gram-Schmidt panels up to 4 MiB with
m % 8 == 0, Householder QR (``torch.linalg.qr``) otherwise. The wire
codec's ``pack_bits``/``unpack_bits`` (``ops.py:113-149``) are
``pack.pack_words``/``unpack_words`` themselves, which run their kernels
at every size: the reference sent payloads under 512 words to its oracle
only because TPU padding would dominate them (``ops.py:124,142``).
``sampled_entropy_hist`` bins through the histogram kernel
(``entropy_hist.py``).
"""
from __future__ import annotations

import torch

from . import entropy_hist as _hist
from . import lowrank as _lr

F32 = torch.float32


def _use_qr(m: int, r: int) -> bool:
    return m * r * 4 > (4 << 20) or m % 8 != 0


def lowrank_p(grad, err, q):
    return _lr.ef_lowrank_p(grad[None], err[None], q[None])[0]


def lowrank_q(grad, err, p_hat):
    return _lr.ef_lowrank_q(grad[None], err[None], p_hat[None])[0]


def decompress_residual(p_hat, q, grad, err):
    g_hat, new_err = _lr.decompress_residual(p_hat[None], q[None], grad[None],
                                             err[None])
    return g_hat[0], new_err[0]


def orthonormalize(p):
    """Gram-Schmidt panel kernel up to 4 MiB, else QR."""
    return orthonormalize3(p[None])[0]


lowrank_p3 = _lr.ef_lowrank_p
lowrank_q3 = _lr.ef_lowrank_q
decompress_residual3 = _lr.decompress_residual


def orthonormalize3(p):
    """Per-slice Gram-Schmidt panels up to 4 MiB each, else QR."""
    _, m, r = p.shape
    if _use_qr(m, r):
        return torch.linalg.qr(p.to(F32))[0]
    return _lr.gram_schmidt_panel(p)


def sampled_entropy_hist(x, num_bins: int = 256, range_sigmas: float = 8.0):
    """Histogram differential entropy (nats) of a flat sample, binned by
    the histogram kernel; mirrors ``repro/kernels/ops.py:151-164``."""
    eps = 1e-12
    x = x.to(F32).reshape(-1)
    mu = torch.mean(x)
    sigma = torch.std(x, unbiased=False) + eps
    lo = mu - range_sigmas * sigma
    width = (2.0 * range_sigmas * sigma) / num_bins
    counts = _hist.hist_counts(x, lo, 1.0 / width, num_bins=num_bins)
    p = counts / x.shape[0]
    plogp = torch.where(p > 0, p * torch.log(p + eps), torch.zeros_like(p))
    return -torch.sum(plogp) + torch.log(width + eps)
