"""Flash attention for training: forward with LSE, recompute-form backward.

Port of ``repro/kernels/flash_attention_bwd.py``:

* ``_fwd_with_stats`` runs the forward kernel of ``flash_attention.py``
  for the inputs' dtype with its log-sum-exp rows (replaces ``:153
  _fwd_with_stats``, ``_fwd_kernel``);
* ``flash_dq`` wraps the dQ kernel (replaces ``_dq_kernel`` of ``:186
  _bwd``): per query tile, over the key tiles, P = exp(S * scale - L),
  dP = dO V^T and dS = P (dP - D), and dQ = sum dS K * scale;
* ``flash_dkv`` wraps the dK/dV kernel (replaces ``_dkv_kernel``): per
  key tile, over the query tiles, dV = sum P^T dO and dK = sum dS^T Q *
  scale, summed over the query heads that share the kv head.

Each input dtype has exactly one kernel per gradient, chosen by dtype:

* bf16 runs ``csrc/flash_bwd_sm90.cu`` on the tensor cores: a block of two
  warpgroups owns 128 query rows (dQ) or keys (dK/dV), and its first
  thread streams the other side's tiles by TMA through a ring of
  shared-memory stages; all five product types are ``wgmma`` with fp32
  sums, and P and dS enter the products that take them from registers,
  rounded to bf16 (the one place they round unlike the reference).
  ``sm90_bwd_plan`` states each kernel's tiles, ring depth, shared memory
  and register arithmetic per head width. Under GQA the dK/dV kernel
  writes fp32 partials per query head, summed here over each kv head's
  group, as the reference sums them after its kernel (``:243-246``);
* fp32 runs ``flash_dq_kernel`` / ``flash_dkv_kernel`` of ``csrc/flash.cu``
  (fp32 FMAs; the dK/dV kernel sums the GQA group inside the block).
  ``wgmma`` has no fp32 mode, and TF32 falls short of the 1e-5 fp32 bar.

Neither path uses atomics, so two calls on the same inputs agree bit for
bit.

``flash_attention_train`` is what the reference's ``custom_vjp`` was: the
op ``repro_torch::flash_attention`` (``torch.library``), whose forward
saves (q, k, v, o, lse) with o in q's dtype, and whose backward, the op
``repro_torch::flash_attention_backward``, computes D = rowsum(dO * o) in
fp32 torch from that saved o, as the reference does outside its kernels
(``:197``). Both ops give fake tensors their outputs' shapes without a
kernel, and ``torch.utils.flop_counter`` their products (torch's attention
convention: every (query, key) pair, two products forward, four backward),
so the dry run and ``FlopCounterMode`` count the route the card runs.
Neither kernel synchronises: both run on the current stream.

A wrapper given CPU tensors runs its plain version (``ref.py``); given
CUDA tensors it launches its kernel or raises. ``<wrapper>.launches``
counts kernel launches and ``<wrapper>.launches_by_kernel`` splits them
by kernel (``*_sm90`` for bf16, ``*_fma`` for fp32).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import ClassVar

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build, ref
from .flash_attention import (SMEM_LIMIT, _DTYPE_CODE, _Chunked, _lib,
                              _tma_view, check_head_width, check_qkv,
                              flash_fwd, strides)
from .launch import launch
from .launch import on_cpu as _on_cpu
from .launch import ptr as _ptr

__all__ = ["flash_attention_train", "flash_dq", "flash_dkv", "KERNELS",
           "Sm90BwdPlan", "sm90_bwd_plan"]

F32 = torch.float32
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _sm90_lib() -> ctypes.CDLL:
    lib = build.load("flash_bwd_sm90")
    if not getattr(lib, "_typed", False):
        # q, k, v, dO, lse, delta, then dq (dQ) or dk, dv (dK/dV); B, Tq,
        # Tk, H, Hkv, D, causal; 12 strides; the plan (Sm90BwdPlan.c_args);
        # the stream
        tail = [_I] * 7 + [_L] * 12 + [_I] * 6 + [_P]
        lib.repro_flash_dq_sm90.argtypes = [_P] * 7 + tail
        lib.repro_flash_dkv_sm90.argtypes = [_P] * 8 + tail
        for fn in (lib.repro_flash_dq_sm90, lib.repro_flash_dkv_sm90):
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [_I]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


@dataclasses.dataclass(frozen=True)
class Sm90BwdPlan(_Chunked):
    """Tiles of one bf16 backward kernel (``csrc/flash_bwd_sm90.cu``) at one
    Dh; ``kernel`` is ``"dq"`` or ``"dkv"``.

    A block of two warpgroups owns ``block`` rows: query rows for dQ, keys
    for dK/dV. It brings its own rows (Q and dO, or K and V) once and
    streams the other side's in tiles of ``tile`` rows through a ring of
    ``stages``, the deepest (up to 4) that fits; a dK/dV stage also holds
    the tile's L and D rows. ``tile`` is the widest of 128, 64 and 32 rows
    whose ``fragments`` fit ``frag_budget``: the fp32 accumulators a thread
    holds (dQ: Dh/2; dK and dV: Dh) and the S and dP fragments (tile/2
    each). That leaves the rest of ``max_registers`` for addresses and the
    packed bf16 fragments. The kernel is built with the same numbers and
    refuses a launch that states others.
    """
    kernel: str = "dq"
    block: ClassVar[int] = 128
    threads: ClassVar[int] = 256
    max_stages: ClassVar[int] = 4
    frag_budget: ClassVar[int] = 160
    #: registers a thread may use: a warp's come from one of the SM's four
    #: sub-partitions (16,384 each), which holds ceil(warps / 4) of the
    #: block's warps, in units of 8, and no thread may use more than 255
    max_registers: ClassVar[int] = min(
        255, 16384 // (-(-threads // 128) * 32) // 8 * 8)

    def fragments(self, tile: int) -> int:
        acc = self.dh // 2 if self.kernel == "dq" else self.dh
        return acc + tile

    @property
    def tile(self) -> int:
        return next((n for n in (128, 64) if self.fragments(n) <= self.frag_budget),
                    32)

    @property
    def fixed_bytes(self) -> int:
        """The block's own rows: two bf16 tiles of ``block`` x Dh."""
        return 2 * 2 * self.block * self.dh

    @property
    def stage_bytes(self) -> int:
        """Two bf16 tiles of ``tile`` x Dh, and for dK/dV the tile's fp32 L
        and D rows."""
        rows = 0 if self.kernel == "dq" else 2 * 4 * self.tile
        return 2 * 2 * self.tile * self.dh + rows

    def _smem(self, stages: int) -> int:
        return 1024 + self.fixed_bytes + stages * self.stage_bytes + 128

    @property
    def stages(self) -> int:
        """The deepest ring, 2 to ``max_stages``, within SMEM_LIMIT."""
        return max([2] + [s for s in range(2, self.max_stages + 1)
                          if self._smem(s) <= SMEM_LIMIT])

    @property
    def smem_bytes(self) -> int:
        """The block's rows, the ring, 128 bytes of mbarriers and 1024 of
        alignment."""
        return self._smem(self.stages)

    def c_args(self) -> list[int]:
        return [self.block, self.tile, self.threads, self.swizzle,
                self.stages, self.smem_bytes]


def sm90_bwd_plan(dh: int, kernel: str) -> Sm90BwdPlan:
    """The plan of the bf16 ``kernel`` ("dq" or "dkv") at head width ``dh``
    (one of ``HEAD_DIMS``)."""
    check_head_width(dh)
    if kernel not in ("dq", "dkv"):
        raise ValueError(f"kernel {kernel!r}: want 'dq' or 'dkv'")
    plan = Sm90BwdPlan(dh, kernel)
    assert plan.smem_bytes <= SMEM_LIMIT, plan
    return plan


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
    D = rowsum(dO * o), both (B, H, Tq) fp32.

    On CUDA, bf16 inputs launch the tensor-core kernel
    (``csrc/flash_bwd_sm90.cu``) and fp32 inputs the fp32 kernel
    (``csrc/flash.cu``); there is no other path.
    """
    if _on_cpu(q, k, v, do, lse, delta):
        return ref.flash_dq(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta, dims = _bwd_inputs(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        # TMA reads q, k, v and dO (a tensor it cannot read in place is
        # copied, and the copy held until the launch)
        (q, sq), (k, sk), (v, sv), (do, sd) = (_tma_view(t) for t in (q, k, v, do))
        launch(_sm90_lib(), flash_dq, "repro_flash_dq_sm90", q.device, _ptr(q),
               _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
               *dims, int(causal), *sq, *sk, *sv, *sd,  # lint: allow(host-call-in-hot-path) causal is a Python bool
               *sm90_bwd_plan(dims[5], "dq").c_args())
        flash_dq.launches_by_kernel["flash_dq_sm90"] += 1
    else:
        launch(_lib(), flash_dq, "repro_flash_dq", q.device, _ptr(q),
               _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
               *dims, int(causal), _DTYPE_CODE[q.dtype], *strides(q),  # lint: allow(host-call-in-hot-path) causal is a Python bool
               *strides(k), *strides(v), *strides(do))
        flash_dq.launches_by_kernel["flash_dq_fma"] += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool = True):
    """(dK, dV), each (B, Tk, Hkv, Dh) in k's dtype and summed over the
    query heads that share its kv head.

    On CUDA, bf16 inputs launch the tensor-core kernel
    (``csrc/flash_bwd_sm90.cu``), which under GQA writes fp32 partials per
    query head that are summed here; fp32 inputs launch the fp32 kernel
    (``csrc/flash.cu``), which sums the group in the block.
    """
    if _on_cpu(q, k, v, do, lse, delta):
        return ref.flash_dkv(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta, dims = _bwd_inputs(q, k, v, do, lse, delta)
    B, _, Tk, H, Hkv, Dh = dims
    if q.dtype == torch.bfloat16:
        rep = H // Hkv
        shape, dtype = ((B, Tk, Hkv, Dh), k.dtype) if rep == 1 else \
            ((B, Tk, H, Dh), F32)
        dk = torch.empty(shape, dtype=dtype, device=k.device)
        dv = torch.empty(shape, dtype=dtype, device=k.device)
        (q, sq), (k, sk), (v, sv), (do, sd) = (_tma_view(t) for t in (q, k, v, do))
        launch(_sm90_lib(), flash_dkv, "repro_flash_dkv_sm90", q.device,
               _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
               _ptr(dk), _ptr(dv), *dims, int(causal), *sq, *sk, *sv, *sd,  # lint: allow(host-call-in-hot-path) causal is a Python bool
               *sm90_bwd_plan(Dh, "dkv").c_args())
        flash_dkv.launches_by_kernel["flash_dkv_sm90"] += 1
        if rep > 1:   # query head h = g * rep + r of kv head g
            dk, dv = (t.view(B, Tk, Hkv, rep, Dh).sum(3).to(k.dtype)
                      for t in (dk, dv))
        return dk, dv
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    launch(_lib(), flash_dkv, "repro_flash_dkv", q.device, _ptr(q), _ptr(k),
           _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv),
           *dims, int(causal), _DTYPE_CODE[q.dtype], *strides(q),  # lint: allow(host-call-in-hot-path) causal is a Python bool
           *strides(k), *strides(v), *strides(do))
    flash_dkv.launches_by_kernel["flash_dkv_fma"] += 1
    return dk, dv


def _bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """(dq, dk, dv) of attention at (q, k, v), given the forward's o (in
    q's dtype, as saved) and lse, and the output gradient dO."""
    delta = ref.flash_delta(o, do)
    dq = flash_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return _fwd_with_stats(q, k, v, causal=causal)


@_flash_op.register_fake
def _(q, k, v, causal):
    B, Tq, H, _ = q.shape
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty((B, H, Tq), dtype=F32, device=q.device))


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    dq, dk, dv = _bwd(q, k, v, o, lse, do, causal=causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@_flash_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal):
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (q, k, v))


def _setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal = causal
    ctx.set_materialize_grads(False)     # lse's gradient is never used


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    return (*torch.ops.repro_torch.flash_attention_backward(
        q, k, v, o, lse, do, ctx.causal), None)


_flash_op.register_autograd(_backward, setup_context=_setup_context)


def _attn_flops(q_shape, k_shape, products: int) -> int:
    """``products`` (query, key) products of Dh each over every pair of
    every query head, unmasked, as torch's attention formulas count."""
    B, Tq, H, Dh = q_shape
    return 2 * products * B * H * Tq * k_shape[1] * Dh


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _fwd_flops(q_shape, k_shape, *args, **kwargs) -> int:
    return _attn_flops(q_shape, k_shape, 2)           # Q K^T, P V


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _bwd_flops(q_shape, k_shape, *args, **kwargs) -> int:
    return _attn_flops(q_shape, k_shape, 4)           # dO V^T, P^T dO, dS K, dS^T Q


def flash_attention_train(q, k, v, causal: bool = True):
    """Differentiable GQA attention, (B, Tq, H, Dh) in q's dtype, whose
    forward and backward run the flash kernels on CUDA tensors."""
    return _flash_op(q, k, v, causal)[0]


#: The kernels of this module: launch counters live on these wrappers.
KERNELS = (flash_dq, flash_dkv)
for _fn in KERNELS:
    _fn.launches = 0
del _fn
#: Launches by kernel: bf16 (tensor cores) and fp32 (FMA).
flash_dq.launches_by_kernel = {"flash_dq_sm90": 0, "flash_dq_fma": 0}
flash_dkv.launches_by_kernel = {"flash_dkv_sm90": 0, "flash_dkv_fma": 0}
