"""Plain torch oracles for the PowerSGD kernels (port of ``repro/kernels/ref.py``).

Written with ``@`` and ``transpose(-1, -2)``, so each one takes a 2-D
``(m, n)`` leaf or a batched ``(E, m, n)`` stack alike.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def ef_lowrank_p(grad, err, q):
    """Fused error-feedback + P factor: P = (grad + err) @ q, fp32."""
    return (grad.to(F32) + err.to(F32)) @ q.to(F32)


def ef_lowrank_q(grad, err, p_hat):
    """Fused error-feedback + Q factor: Q = (grad + err)^T @ p_hat, fp32."""
    return (grad.to(F32) + err.to(F32)).transpose(-1, -2) @ p_hat.to(F32)


def decompress_residual(p_hat, q, grad, err):
    """g_hat = p_hat @ q^T and the new EF residual (grad + err) - g_hat."""
    g_hat = p_hat.to(F32) @ q.to(F32).transpose(-1, -2)
    new_err = grad.to(F32) + err.to(F32) - g_hat
    return g_hat, new_err


def gram_schmidt(p, eps: float = 1e-8):
    """Column-wise modified Gram-Schmidt (m, r) -> orthonormal (m, r)."""
    p = p.to(F32)
    cols = []
    for i in range(p.shape[1]):
        v = p[:, i]
        for u in cols:
            v = v - torch.dot(u, v) * u
        v = v / (torch.linalg.norm(v) + eps)
        cols.append(v)
    return torch.stack(cols, dim=1)
