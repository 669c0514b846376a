"""Flash attention for training: forward with LSE, recompute-form backward.

Port of ``repro/kernels/flash_attention_bwd.py``. The CUDA C++ lives in
``csrc/flash.cu`` (and, for the bf16 forward, ``csrc/flash_fwd_sm90.cu``):

* ``_fwd_with_stats`` runs the forward kernel of ``flash_attention.py``
  for the inputs' dtype with its log-sum-exp rows (replaces ``:153
  _fwd_with_stats``, ``_fwd_kernel``);
* ``flash_dq`` wraps the dQ kernel (replaces ``_dq_kernel`` of ``:186
  _bwd``): one block per (batch, query head, query tile) loops over key
  tiles, recomputing P = exp(S * scale - L), dP = dO V^T and
  dS = P (dP - D), and sums dS K * scale;
* ``flash_dkv`` wraps the dK/dV kernel (replaces ``_dkv_kernel``): one
  block per (batch, kv head, key tile) loops over the query heads that
  share the kv head and their query tiles, and sums P^T dO and
  dS^T Q * scale in fp32 before it writes dK and dV once in k's dtype.
  The reference wrote fp32 (B*H, Tk, Dh) per query head and summed the GQA
  groups afterwards (``:243-246``); summing in the kernel computes the
  same function without atomics.

``flash_attention_train`` is the ``torch.autograd.Function`` the
reference's ``custom_vjp`` was: its forward saves (q, k, v, o, lse) with o
in q's dtype, and its backward computes D = rowsum(dO * o) in fp32 torch
from that saved o, as the reference does outside its kernels (``:197``).
Neither kernel synchronises: both run on the current stream.

A wrapper given CPU tensors runs its plain version (``ref.py``); given
CUDA tensors it launches its kernel or raises. ``<wrapper>.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import _DTYPE_CODE, _lib, check_qkv, flash_fwd, strides
from .launch import launch
from .launch import on_cpu as _on_cpu
from .launch import ptr as _ptr

__all__ = ["flash_attention_train", "flash_dq", "flash_dkv", "KERNELS"]

F32 = torch.float32


def _fwd_with_stats(q, k, v, *, causal: bool = True):
    """(o, lse): o (B, Tq, H, Dh) in q's dtype, lse (B, H, Tq) fp32."""
    return flash_fwd(q, k, v, causal=causal, with_lse=True)


def _bwd_inputs(q, k, v, do, lse, delta):
    q, k, v, dims = check_qkv(q, k, v)
    B, Tq, _, H, _, Dh = dims
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    do = do.to(q.dtype)
    do = do if do.stride(-1) == 1 else do.contiguous()
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Tq) or t.dtype != F32:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: want fp32 "
                             f"{(B, H, Tq)}")
    return q, k, v, do, lse.contiguous(), delta.contiguous(), dims


def flash_dq(q, k, v, do, lse, delta, *, causal: bool = True):
    """dQ (B, Tq, H, Dh) in q's dtype, from the forward's lse and
    D = rowsum(dO * o), both (B, H, Tq) fp32."""
    if _on_cpu(q, k, v, do, lse, delta):
        return ref.flash_dq(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta, dims = _bwd_inputs(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch(_lib(), flash_dq, "repro_flash_dq", q.device, _ptr(q), _ptr(k),
           _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq), *dims,
           int(causal), _DTYPE_CODE[q.dtype], *strides(q), *strides(k),
           *strides(v), *strides(do))
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool = True):
    """(dK, dV), each (B, Tk, Hkv, Dh) in k's dtype and summed over the
    query heads that share its kv head."""
    if _on_cpu(q, k, v, do, lse, delta):
        return ref.flash_dkv(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta, dims = _bwd_inputs(q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    launch(_lib(), flash_dkv, "repro_flash_dkv", q.device, _ptr(q), _ptr(k),
           _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv),
           *dims, int(causal), _DTYPE_CODE[q.dtype], *strides(q),
           *strides(k), *strides(v), *strides(do))
    return dk, dv


def _bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """(dq, dk, dv) of attention at (q, k, v), given the forward's o (in
    q's dtype, as saved) and lse, and the output gradient dO."""
    delta = ref.flash_delta(o, do)
    dq = flash_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _fwd_with_stats(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do, causal=ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention_train(q, k, v, causal: bool = True):
    """Differentiable GQA attention, (B, Tq, H, Dh) in q's dtype, whose
    forward and backward run the flash kernels on CUDA tensors."""
    return _FlashAttention.apply(q, k, v, causal)


#: The kernels of this module: launch counters live on these wrappers.
KERNELS = (flash_dq, flash_dkv)
for _fn in KERNELS:
    _fn.launches = 0
del _fn
