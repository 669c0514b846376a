"""Rank-r low-rank gradient compression with error feedback (PowerSGD [66]).

Port of ``repro/core/powersgd.py``: one power iteration with a warm-started
Q, orthonormalization, and an error-feedback residual. The data-parallel
collective is injected (``psum_mean``), so the same code runs on one
worker (identity) and under ``torch.distributed`` (``dist/collectives``).

Leaves are matricized to (m, n) with n = trailing dim; 3-D leaves and
bucketed shape groups are (E, m, n) stacks compressed per slice with one
collective per factor; >3-D leaves fold to one batch dim. Compression
internals run in fp32 whatever the gradient dtype.

``compress_leaf_tp`` compresses one tensor-parallel shard of a leaf (the
``model`` mesh axis): the same round on this process's columns or rows,
with the sums GSPMD inserts in the reference as explicit model-group
collectives, so every shard ends up with its part of the whole leaf's ĝ
and EF, and every process with the whole Q.

Random warm starts come from explicit ``torch.Generator``s seeded by
``fold_in(seed, i)``, the port's counterpart of ``jax.random.fold_in``;
they are not the reference's numbers, so parity tests copy Q across.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.ref import gram_schmidt

__all__ = ["LowRankState", "gram_schmidt", "fold_in", "normal",
           "init_leaf_state", "compress_leaf", "compress_leaf_tp", "resize_rank",
           "compressed_bytes", "ef_norm_sq"]

PsumFn = Callable[[torch.Tensor], torch.Tensor]
F32 = torch.float32


def _identity_psum(x: torch.Tensor) -> torch.Tensor:
    return x


class LowRankState(NamedTuple):
    """Per-leaf compressor state: warm-start Q and error-feedback residual."""

    q: torch.Tensor    # (n, r) or (E, n, r), fp32
    err: torch.Tensor  # (m, n) or (E, m, n)


def fold_in(seed: int, i: int) -> int:
    """Derive an independent 63-bit seed from (seed, i)."""
    x = (seed * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) % (1 << 64)
    x ^= x >> 31
    return (x * 0x94D049BB133111EB % (1 << 64)) >> 1


def normal(shape, seed: int, device) -> torch.Tensor:
    """Standard-normal fp32 draws from a CPU generator seeded with ``seed``,
    moved to ``device``: the same numbers on every device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen, dtype=F32).to(device)


def _orthonormalize(p: torch.Tensor) -> torch.Tensor:
    """QR orthonormalization (same span as Gram-Schmidt), batched."""
    return torch.linalg.qr(p.to(F32))[0]


def init_leaf_state(shape: tuple[int, ...], rank: int, seed: int,
                    dtype=F32, device="cpu") -> LowRankState:
    """Random warm-start Q (as PowerSGD) + zero error-feedback residual."""
    if len(shape) < 2:
        raise ValueError(f"unsupported leaf shape {shape}")
    q = normal(tuple(shape[:-2]) + (shape[-1], rank), seed, device)
    return LowRankState(q=q, err=torch.zeros(shape, dtype=dtype, device=device))


def ef_norm_sq(comp: dict, device=None) -> torch.Tensor:
    """Total squared error-feedback residual across a compressor dict (a
    DTensor residual's local squares summed over its split), on the
    residuals' device (``device`` when the dict holds none)."""
    from repro_torch.dist import tp
    errs = [st.err for st in comp.values() if isinstance(st, LowRankState)]
    sq = [torch.sum(tp.local(e).to(F32) ** 2) for e in errs]
    if any(tp.sharded_dims(e) for e in errs):
        sq = tp.leafwise_sums(sq, errs)
    # made on the device: a host zero copied there would wait for it
    total = torch.zeros((), dtype=F32,
                        device=errs[0].device if errs else device)
    for e, v in zip(errs, sq):
        total = total.to(e.device) + v
    return total


@torch.no_grad()
def compress_leaf(grad: torch.Tensor, state: LowRankState,
                  psum_mean: PsumFn = _identity_psum,
                  use_kernels: bool = False):
    """Compress + all-reduce + decompress one leaf (2-D, 3-D or folded >3-D).

    Returns (decompressed gradient, new state).
    """
    if grad.ndim > 3:
        shape = grad.shape
        folded = grad.reshape((-1,) + tuple(shape[-2:]))
        st = LowRankState(q=state.q.reshape((-1,) + tuple(state.q.shape[-2:])),
                          err=state.err.reshape(folded.shape))
        g_hat, st2 = compress_leaf(folded, st, psum_mean, use_kernels)
        return g_hat.reshape(shape), LowRankState(
            q=st2.q.reshape(tuple(state.q.shape[:-1]) + (st2.q.shape[-1],)),
            err=st2.err.reshape(shape))
    if grad.ndim not in (2, 3):
        raise ValueError(f"unsupported grad ndim {grad.ndim}")
    return _round(grad, state.err, state.q, use_kernels, psum_mean, psum_mean)


def _round_fns(ndim: int, use_kernels: bool):
    """(P, orthonormalize, Q, decompress) of one PowerSGD round on (m, n)
    or (E, m, n) operands: the Hopper kernels (EF add fused) or plain torch
    in fp32."""
    if use_kernels:
        from repro_torch.kernels import ops as kops
        if ndim == 2:
            return (kops.lowrank_p, kops.orthonormalize, kops.lowrank_q,
                    kops.decompress_residual)
        return (kops.lowrank_p3, kops.orthonormalize3, kops.lowrank_q3,
                kops.decompress_residual3)
    m_of = lambda g, e: g.to(F32) + e.to(F32)

    def dec(p_hat, q, g, e):
        g_hat = p_hat @ q.transpose(-1, -2)
        return g_hat, m_of(g, e) - g_hat

    return (lambda g, e, q: m_of(g, e) @ q, _orthonormalize,
            lambda g, e, p: m_of(g, e).transpose(-1, -2) @ p, dec)


def _round(grad, err, q, use_kernels: bool, reduce_p: PsumFn,
           reduce_q: PsumFn, local_rows: PsumFn = _identity_psum):
    """One PowerSGD round: P = (G+E)·Q, reduced (the DP collective #1 and
    any model-group sum or gather) and orthonormalized, cut to this
    process's rows; Q' = (G+E)ᵀ·P̂, reduced (collective #2); ĝ = P̂Q'ᵀ and
    E' = G+E-ĝ. Returns (ĝ, new state) in the gradient's dtype."""
    p_fn, orth, q_fn, dec = _round_fns(grad.ndim, use_kernels)
    p_hat = local_rows(orth(reduce_p(p_fn(grad, err, q))))
    q_new = reduce_q(q_fn(grad, err, p_hat))
    g_hat, new_err = dec(p_hat, q_new, grad, err)
    return g_hat.to(grad.dtype), LowRankState(q=q_new,
                                              err=new_err.to(grad.dtype))


@torch.no_grad()
def compress_leaf_tp(grad: torch.Tensor, state: LowRankState, dim: int | None,
                     index: int, psum_mean: PsumFn, model_psum: PsumFn,
                     model_gather, use_kernels: bool = False):
    """One PowerSGD round on this process's shard of a leaf split over the
    model group on ``dim`` (of the whole leaf's dims; None: held whole).

    ``grad`` and ``state.err`` are the local shards, ``state.q`` the whole
    warm-start Q; ``index`` is this process's place in the model group,
    ``model_psum`` sums over it and ``model_gather(t, dim)`` concatenates
    its shards. By where the split falls:

      * column (the last dim): P = (G+E)·Q over the local columns and their
        rows of Q is a partial sum: summed over the model group, then the
        DP mean; Q' = (G+E)ᵀ·P̂ is local rows of the whole Q';
      * row (dim -2): P is local rows: the DP mean, then gathered over the
        model group and orthonormalized whole; Q' = (G+E)ᵀ·P̂ over the
        local rows is a partial sum: summed, then the DP mean;
      * a leading dim (MoE experts): every slice is local, no model sum.

    Returns (the local shard of ĝ, the new state: whole Q, local EF).
    """
    nd = grad.ndim
    if dim is None:
        return compress_leaf(grad, state, psum_mean, use_kernels)
    if dim < nd - 2:
        # expert slices: the round is local to each; Q's slices follow
        q_loc = state.q.narrow(dim, index * grad.shape[dim], grad.shape[dim])
        g_hat, st = compress_leaf(grad, LowRankState(q_loc.contiguous(),
                                                     state.err),
                                  psum_mean, use_kernels)
        return g_hat, LowRankState(model_gather(st.q, dim), st.err)
    if nd > 3:
        shape = grad.shape
        fold = lambda t: t.reshape((-1,) + tuple(t.shape[-2:]))
        g_hat, st = compress_leaf_tp(
            fold(grad), LowRankState(fold(state.q), fold(state.err)),
            dim - nd + 3, index, psum_mean, model_psum, model_gather,
            use_kernels)
        return g_hat.reshape(shape), LowRankState(
            st.q.reshape(state.q.shape), st.err.reshape(shape))
    if dim == nd - 1:                                   # column-parallel
        n_loc = grad.shape[-1]
        q_loc = state.q.narrow(-2, index * n_loc, n_loc).contiguous()
        g_hat, st = _round(grad, state.err, q_loc, use_kernels,
                           lambda p: psum_mean(model_psum(p)), psum_mean)
        return g_hat, LowRankState(model_gather(st.q, -2), st.err)
    m_loc = grad.shape[-2]                              # row-parallel
    return _round(grad, state.err, state.q, use_kernels,
                  lambda p: model_gather(psum_mean(p), -2),
                  lambda q: psum_mean(model_psum(q)),
                  lambda p: p.narrow(-2, index * m_loc, m_loc).contiguous())


def resize_rank(state: LowRankState, new_rank: int, seed: int) -> LowRankState:
    """Grow/shrink the warm-start Q when DAC moves the rank.

    Shrinking keeps the leading columns; growing appends fresh random
    columns. The EF residual is preserved.
    """
    q = state.q
    r = q.shape[-1]
    if new_rank == r:
        return state
    if new_rank < r:
        q_new = q[..., :new_rank]
    else:
        extra = normal(tuple(q.shape[:-1]) + (new_rank - r,), seed, q.device)
        q_new = torch.cat([q, extra], dim=-1)
    return LowRankState(q=q_new, err=state.err)


def compressed_bytes(shape: tuple[int, ...], rank: int,
                     bytes_per_elem: int = 2) -> int:
    """Wire bytes for one leaf at one rank: (m + n) * r (* batch)."""
    m, n = shape[-2:]
    batch = 1
    for d in shape[:-2]:
        batch *= d
    return batch * (m + n) * rank * bytes_per_elem
