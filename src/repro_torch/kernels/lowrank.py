"""Hopper kernels for the PowerSGD hot spots, with their plain versions.

The CUDA C++ lives in ``csrc/lowrank.cu`` (built by ``build.py``, loaded
with ``ctypes``). Every wrapper takes batched ``(E, ...)`` stacks, which is
what the bucketed executor hands it; the 2-D per-leaf forms are E = 1
(``ops.py``). A wrapper given CPU tensors runs its plain version; given
CUDA tensors it launches its kernel or raises. ``<wrapper>.launches``
counts kernel launches.

Design notes, per kernel (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32 FMA):

* ``ef_lowrank_p`` replaces ``repro/kernels/lowrank.py:188
  ef_lowrank_p_batched``. (G+E) is read once at 2r FLOP per element, so at
  r = 64 in fp32 (16 FLOP per 8 bytes) it is bound by bytes. The TPU kernel
  summed over n on its sequential grid axis; Hopper blocks run in no order,
  so each block owns a (64 x 64) tile of P and loops over n itself, staging
  the (G+E) tile (the EF add happens on load) and the Q panel in shared
  memory. When fewer than four blocks per SM would run, the n loop is split
  and a second pass sums the partials in split order (no atomics).
* ``ef_lowrank_q`` replaces ``:218 ef_lowrank_q_batched``: the tall
  reduction over m, with the same tiles, the same split rule and the same
  bound.
* ``decompress_residual`` replaces ``:247 decompress_residual_batched``.
  Each block computes one (64 x 64) tile of ghat = P Q^T (inner dimension
  r, staged 32 at a time), reads G and E once and writes ghat and E' once
  in G's dtype: bound by bytes.
* ``gram_schmidt_panel`` replaces ``:288 gram_schmidt_panel_batched``:
  classical Gram-Schmidt, eps 1e-8, as ``_gs3_kernel`` computes it. The TPU
  kept the whole panel (up to 4 MiB) in VMEM; that does not fit a Hopper
  block's 227 KB of shared memory, so one block per slice works on a
  column-major copy of the panel in device memory (L2-resident), with
  block reductions for the dot products. It is bound by its serial column
  loop; at E <= 32 it fills at most 32 of the 132 SMs.

All four accumulate in fp32 FMA (no TF32) and use no atomics.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .launch import launch
from .launch import on_cpu as _on_cpu
from .launch import ptr as _ptr

__all__ = ["ef_lowrank_p", "ef_lowrank_q", "decompress_residual",
           "gram_schmidt_panel", "KERNELS", "plain_gram_schmidt"]

F32 = torch.float32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("lowrank")
    if not getattr(lib, "_typed", False):
        factor = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.repro_lowrank_p.argtypes = factor
        lib.repro_lowrank_q.argtypes = factor
        lib.repro_decompress_residual.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        lib.repro_gram_schmidt.argtypes = [_P, _P, _P, _I, _I, _I,
                                           ctypes.c_float, _P]
        for fn in (lib.repro_lowrank_p, lib.repro_lowrank_q,
                   lib.repro_decompress_residual, lib.repro_gram_schmidt):
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [_I]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(wrapper, name: str, device: torch.device, *args) -> None:
    """Launch entry point ``name`` of ``csrc/lowrank.cu`` (see ``launch.py``)."""
    launch(_lib(), wrapper, name, device, *args)


def _gradient_pair(grad, err):
    if grad.ndim != 3 or err.shape != grad.shape:
        raise ValueError(f"want matching (E, m, n) stacks, got "
                         f"{tuple(grad.shape)} and {tuple(err.shape)}")
    if grad.dtype not in _DTYPE_CODE or err.dtype != grad.dtype:
        raise TypeError(f"gradient/EF dtypes {grad.dtype}/{err.dtype}: the "
                        "kernels take fp32 or bf16, both the same")
    return grad.contiguous(), err.contiguous()


def _factor(t, shape) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"factor shape {tuple(t.shape)}, want {tuple(shape)}")
    return t.to(F32).contiguous()


def _splits(blocks: int, depth: int, device) -> int:
    """Split the reduction until ~4 blocks per SM run (chunks >= 256 deep)."""
    target = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    splits = 1
    while blocks * splits < target and depth // (2 * splits) >= 256:
        splits *= 2
    return splits


def _launch_factor(wrapper, fn_name: str, grad, err, f, rows: int, depth: int):
    """Launch the P (or Q) kernel; counts the launch on ``wrapper``."""
    num_e, m, n = grad.shape
    r = f.shape[-1]
    out = torch.empty((num_e, rows, r), dtype=F32, device=grad.device)
    if out.numel() == 0 or depth == 0:
        return out.zero_()
    blocks = num_e * -(-rows // 64) * -(-r // 64)
    splits = _splits(blocks, depth, grad.device)
    partial = (torch.empty((splits, num_e, rows, r), dtype=F32,
                           device=grad.device) if splits > 1 else out)
    _launch(wrapper, fn_name, grad.device, _ptr(grad), _ptr(err), _ptr(f),
            _ptr(out), _ptr(partial), num_e, m, n, r, splits,
            _DTYPE_CODE[grad.dtype])
    return out


def ef_lowrank_p(grad, err, q):
    """P[e] = (grad[e] + err[e]) @ q[e]: (E, m, n) x (E, n, r) -> (E, m, r) fp32."""
    if _on_cpu(grad, err, q):
        return ref.ef_lowrank_p(grad, err, q)
    grad, err = _gradient_pair(grad, err)
    num_e, m, n = grad.shape
    q = _factor(q, (num_e, n, q.shape[-1]))
    return _launch_factor(ef_lowrank_p, "repro_lowrank_p", grad, err, q,
                          rows=m, depth=n)


def ef_lowrank_q(grad, err, p_hat):
    """Q[e] = (grad[e] + err[e])^T @ p_hat[e]: -> (E, n, r) fp32."""
    if _on_cpu(grad, err, p_hat):
        return ref.ef_lowrank_q(grad, err, p_hat)
    grad, err = _gradient_pair(grad, err)
    num_e, m, n = grad.shape
    p_hat = _factor(p_hat, (num_e, m, p_hat.shape[-1]))
    return _launch_factor(ef_lowrank_q, "repro_lowrank_q", grad, err, p_hat,
                          rows=n, depth=m)


def decompress_residual(p_hat, q, grad, err):
    """(g_hat, new_err), both (E, m, n) in grad's dtype, in one pass."""
    if _on_cpu(p_hat, q, grad, err):
        g_hat, new_err = ref.decompress_residual(p_hat, q, grad, err)
        return g_hat.to(grad.dtype), new_err.to(grad.dtype)
    grad, err = _gradient_pair(grad, err)
    num_e, m, n = grad.shape
    r = q.shape[-1]
    p_hat = _factor(p_hat, (num_e, m, r))
    q = _factor(q, (num_e, n, r))
    g_hat = torch.empty_like(grad)
    new_err = torch.empty_like(grad)
    if grad.numel() == 0:
        return g_hat, new_err
    _launch(decompress_residual, "repro_decompress_residual", grad.device,
            _ptr(p_hat), _ptr(q), _ptr(grad), _ptr(err), _ptr(g_hat),
            _ptr(new_err), num_e, m, n, r, _DTYPE_CODE[grad.dtype])
    return g_hat, new_err


def plain_gram_schmidt(p, eps: float = 1e-8):
    """Classical Gram-Schmidt of each (m, r) slice, as the kernel computes it.

    Column i: coef = U^T v against all previous columns at once, then
    v -= U coef, then v /= (||v|| + eps).
    """
    p = p.to(F32).clone()
    for i in range(p.shape[-1]):
        v = p[..., i]
        if i > 0:
            u = p[..., :i]
            coef = torch.einsum("...mk,...m->...k", u, v)
            v = v - torch.einsum("...mk,...k->...m", u, coef)
        p[..., i] = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)
    return p


def gram_schmidt_panel(p, eps: float = 1e-8):
    """Orthonormal columns for each slice of an (E, m, r) stack, fp32."""
    if _on_cpu(p):
        return plain_gram_schmidt(p, eps)
    if p.ndim != 3:
        raise ValueError(f"want an (E, m, r) stack, got {tuple(p.shape)}")
    p = p.to(F32).contiguous()
    num_e, m, r = p.shape
    out = torch.empty_like(p)
    if p.numel() == 0:
        return out
    work = torch.empty((num_e, r, m), dtype=F32, device=p.device)
    _launch(gram_schmidt_panel, "repro_gram_schmidt", p.device, _ptr(p),
            _ptr(out), _ptr(work), num_e, m, r, eps)
    return out


#: The kernels of this module: launch counters live on these wrappers.
KERNELS = (ef_lowrank_p, ef_lowrank_q, decompress_residual, gram_schmidt_panel)
for _fn in KERNELS:
    _fn.launches = 0
del _fn
