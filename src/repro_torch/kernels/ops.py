"""Kernel dispatch (port of ``repro/kernels/ops.py:23-149``).

The 2-D per-leaf forms run the batched kernels with E = 1. Unlike the
TPU's ``_tileable`` rule, the Hopper kernels mask ragged edges, so every
shape runs the kernel. The one routing rule kept is the reference's choice
of algorithm for orthonormalization: Gram-Schmidt panels up to 4 MiB with
m % 8 == 0, Householder QR (``torch.linalg.qr``) otherwise. The wire
codec's ``pack_bits``/``unpack_bits`` (``ops.py:113-149``) are
``pack.pack_words``/``unpack_words`` themselves, which run their kernels
at every size: the reference sent payloads under 512 words to its oracle
only because TPU padding would dominate them (``ops.py:124,142``).
"""
from __future__ import annotations

import torch

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

