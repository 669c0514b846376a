"""Plain torch oracles for the port's kernels (port of ``repro/kernels/ref.py``).

The PowerSGD oracles are written with ``@`` and ``transpose(-1, -2)``, so
each one takes a 2-D ``(m, n)`` leaf or a batched ``(E, m, n)`` stack
alike. The bit-pack oracles compute in int64 and narrow: torch has no
``<<``/``>>`` for ``uint32``. Packed words are ``torch.uint32`` tensors,
made and read through int32 views of the same bits, which every device
supports.

The flash-attention oracles materialize every score in fp32, in the
``(B, T, H, Dh)`` layout of the kernels' callers, with GQA heads grouped
as ``h = g * rep + r`` (query head h reads kv head ``h // rep``). Masked
scores are ``NEG_INF``, not ``-inf``, as in the reference kernels. The
histogram oracle counts with ``bincount``; the oracle of
``ops.sampled_entropy_hist`` (the reference's ``ref.py:50``) is
``core.entropy.histogram_entropy``, which bins the same way.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
NEG_INF = -1e30


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


# ----------------------------------------------------------- flash attention
def flash_reference(q, k, v, causal: bool = True):
    """Plain full-materialization GQA attention (port of ``ref.py:97``).

    q: (B, Tq, H, Dh); k, v: (B, Tk, Hkv, Dh). Softmax in fp32, output in
    q's dtype.
    """
    B, Tq, H, Dh = q.shape
    _, Tk, Hkv, _ = k.shape
    qh = q.reshape(B, Tq, Hkv, H // Hkv, Dh).to(F32)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qh, k.to(F32)) / math.sqrt(Dh)
    if causal:
        s = s.masked_fill(~_causal_mask(Tq, Tk, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(F32))
    return o.reshape(B, Tq, H, Dh).to(q.dtype)


def _causal_mask(tq: int, tk: int, device) -> torch.Tensor:
    return (torch.arange(tq, device=device)[:, None]
            >= torch.arange(tk, device=device)[None, :])


def _scores(q, k, causal: bool) -> torch.Tensor:
    """fp32 ``q k^T * scale`` as (B, Hkv, rep, Tq, Tk), masked to NEG_INF."""
    B, Tq, H, Dh = q.shape
    _, Tk, Hkv, _ = k.shape
    qh = q.reshape(B, Tq, Hkv, H // Hkv, Dh).to(F32)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qh, k.to(F32)) * (1.0 / math.sqrt(Dh))
    if causal:
        s = s.masked_fill(~_causal_mask(Tq, Tk, q.device), NEG_INF)
    return s


def _rows(t, hkv: int) -> torch.Tensor:
    """A per-row statistic (B, H, Tq) as (B, Hkv, rep, Tq, 1)."""
    B, H, Tq = t.shape
    return t.reshape(B, hkv, H // hkv, Tq, 1)


def flash_fwd(q, k, v, causal: bool = True):
    """The forward kernel's function: (o, lse).

    o (B, Tq, H, Dh) in q's dtype; lse = m + log(l) (B, H, Tq) fp32, with
    the row sum l clamped at 1e-30 as ``flash_attention_bwd.py:192-194`` does.
    """
    B, Tq, H, Dh = q.shape
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(F32))
    o = o / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(B, H, Tq)
    return o.reshape(B, Tq, H, Dh).to(q.dtype), lse


def flash_delta(o, do) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, as (B, H, Tq); o as saved, in its dtype."""
    return (do.to(F32) * o.to(F32)).sum(dim=-1).transpose(1, 2).contiguous()


def _p_ds(q, k, v, do, lse, delta, causal: bool):
    """Recomputed P = exp(S - L) and dS = P * (dO V^T - D), fp32."""
    B, Tq, H, Dh = q.shape
    hkv = k.shape[2]
    p = torch.exp(_scores(q, k, causal) - _rows(lse, hkv))
    doh = do.reshape(B, Tq, hkv, H // hkv, Dh).to(F32)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", doh, v.to(F32))
    return p, p * (dp - _rows(delta, hkv)), doh


def flash_dq(q, k, v, do, lse, delta, causal: bool = True):
    """dQ = sum_k dS K * scale, (B, Tq, H, Dh) in q's dtype."""
    B, Tq, H, Dh = q.shape
    _, ds, _ = _p_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.to(F32)) * (1.0 / math.sqrt(Dh))
    return dq.reshape(B, Tq, H, Dh).to(q.dtype)


def flash_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """(dK, dV) in k's dtype: sum over the query heads of each kv head of
    dS^T Q * scale and P^T dO."""
    B, Tq, H, Dh = q.shape
    hkv = k.shape[2]
    p, ds, doh = _p_ds(q, k, v, do, lse, delta, causal)
    qh = q.reshape(B, Tq, hkv, H // hkv, Dh).to(F32)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qh) * (1.0 / math.sqrt(Dh))
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, doh)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd(q, k, v, o, lse, do, causal: bool = True):
    """The recompute-form backward of ``flash_attention_bwd.py:3-11``:
    (dq, dk, dv) in q's, k's and v's dtypes."""
    delta = flash_delta(o, do)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal)
    return flash_dq(q, k, v, do, lse, delta, causal), dk, dv


# ----------------------------------------------------------------- histogram
def hist_bins(x, lo, inv_width, num_bins: int = 256):
    """The bin (int64) of each element of flat x: ``(x - lo) * inv_width``
    in fp32, truncated toward zero and clipped to ``[0, num_bins - 1]``.

    The clip is taken in fp32 before the integer cast, so values far out
    of range (and infinities) land in the end bins; NaN lands in bin 0, as
    the kernel's saturating conversion puts it.
    """
    t = (x.to(F32).reshape(-1) - lo) * inv_width
    t = torch.nan_to_num(t, nan=0.0).clamp(0.0, num_bins - 1)
    return t.to(torch.int64)


def hist_counts(x, lo, inv_width, num_bins: int = 256):
    """Counts (num_bins,) of flat x's ``hist_bins``, exact in int64, then
    fp32 (which rounds a count above 2**24 to the nearest float)."""
    bins = hist_bins(x, lo, inv_width, num_bins)
    return torch.bincount(bins, minlength=num_bins).to(F32)

