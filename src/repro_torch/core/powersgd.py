"""Rank-r low-rank gradient compression with error feedback (PowerSGD [66]).

Port of ``repro/core/powersgd.py``: one power iteration with a warm-started
Q, orthonormalization, and an error-feedback residual. The data-parallel
collective is injected (``psum_mean``), so the same code runs on one
worker (identity) and under ``torch.distributed`` (``dist/collectives``).

Leaves are matricized to (m, n) with n = trailing dim; 3-D leaves and
bucketed shape groups are (E, m, n) stacks compressed per slice with one
collective per factor; >3-D leaves fold to one batch dim. Compression
internals run in fp32 whatever the gradient dtype.

Random warm starts come from explicit ``torch.Generator``s seeded by
``fold_in(seed, i)``, the port's counterpart of ``jax.random.fold_in``;
they are not the reference's numbers, so parity tests copy Q across.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.ref import gram_schmidt

__all__ = ["LowRankState", "gram_schmidt", "fold_in", "normal",
           "init_leaf_state", "compress_leaf", "resize_rank",
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


def ef_norm_sq(comp: dict) -> torch.Tensor:
    """Total squared error-feedback residual across a compressor dict."""
    total = torch.zeros((), dtype=F32)
    for st in comp.values():
        if isinstance(st, LowRankState):
            total = total.to(st.err.device) + torch.sum(st.err.to(F32) ** 2)
    return total


def _compress_kernels(grad, state, psum_mean):
    """One PowerSGD round through the Hopper kernels (EF add fused)."""
    from repro_torch.kernels import ops as kops
    if grad.ndim == 2:
        p_fn, orth, q_fn, dec = (kops.lowrank_p, kops.orthonormalize,
                                 kops.lowrank_q, kops.decompress_residual)
    else:
        p_fn, orth, q_fn, dec = (kops.lowrank_p3, kops.orthonormalize3,
                                 kops.lowrank_q3, kops.decompress_residual3)
    p = psum_mean(p_fn(grad, state.err, state.q))       # DP collective #1
    p_hat = orth(p)
    q_new = psum_mean(q_fn(grad, state.err, p_hat))     # DP collective #2
    g_hat, err = dec(p_hat, q_new, grad, state.err)
    return g_hat.to(grad.dtype), LowRankState(q=q_new, err=err.to(grad.dtype))


def _compress_plain(grad, state, psum_mean):
    """One PowerSGD round in plain torch (2-D or batched (E, m, n))."""
    m_mat = grad.to(F32) + state.err.to(F32)          # error feedback add
    p = psum_mean(m_mat @ state.q)                     # DP collective #1
    p_hat = _orthonormalize(p)
    q_new = psum_mean(m_mat.transpose(-1, -2) @ p_hat)  # DP collective #2
    g_hat = p_hat @ q_new.transpose(-1, -2)            # decompress
    err = (m_mat - g_hat).to(grad.dtype)               # new residual
    return g_hat.to(grad.dtype), LowRankState(q=q_new, err=err)


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
    if use_kernels:
        return _compress_kernels(grad, state, psum_mean)
    return _compress_plain(grad, state, psum_mean)


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
