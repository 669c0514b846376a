"""Plain torch oracles for the port's kernels (port of ``repro/kernels/ref.py``).

The PowerSGD oracles are written with ``@`` and ``transpose(-1, -2)``, so
each one takes a 2-D ``(m, n)`` leaf or a batched ``(E, m, n)`` stack
alike. The bit-pack oracles compute in int64 and narrow: torch has no
``<<``/``>>`` for ``uint32``. Packed words are ``torch.uint32`` tensors,
made and read through int32 views of the same bits, which every device
supports.
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


_U32_MASK = 0xFFFFFFFF


def pack_bits(codes, bits: int):
    """Bit-pack unsigned codes in [0, 2**bits) into uint32 words.

    codes: flat (n,) integer tensor; bits divides 32 (4 or 8 in practice).
    Returns (ceil(n / (32 // bits)),) uint32 where word w holds
    codes[w*epw : (w+1)*epw] in its low-to-high bit fields; the tail word
    is zero-padded. Codes are not masked, as in the reference: each is
    taken as its 32-bit pattern, shifted, and OR-ed in.
    """
    epw = 32 // bits
    n = codes.shape[0]
    c = codes.to(torch.int64) & _U32_MASK
    pad = (-n) % epw
    if pad:
        c = torch.cat([c, c.new_zeros(pad)])
    c = c.reshape(-1, epw)
    word = c[:, 0]
    for j in range(1, epw):
        word = word | ((c[:, j] << (j * bits)) & _U32_MASK)
    return word.to(torch.int32).view(torch.uint32)


def unpack_bits(words, bits: int, n: int):
    """Inverse of pack_bits: uint32 words -> first n int32 codes."""
    epw = 32 // bits
    mask = (1 << bits) - 1
    w = words.view(torch.int32).to(torch.int64) & _U32_MASK
    cols = [(w >> (j * bits)) & mask for j in range(epw)]
    return torch.stack(cols, dim=1).reshape(-1)[:n].to(torch.int32)
