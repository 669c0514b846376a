"""Flash attention on Hopper: the forward kernel, with its plain version.

The CUDA C++ lives in ``csrc/flash.cu`` (built by ``build.py``, loaded with
``ctypes``). ``flash_fwd`` wraps its forward kernel, which replaces both
``repro/kernels/flash_attention.py:75 flash_attention`` (``_flash_kernel``)
and ``repro/kernels/flash_attention_bwd.py:153 _fwd_with_stats``
(``_fwd_kernel``): one kernel writes o and, when asked, the log-sum-exp
rows the backward needs. The backward kernels are in
``flash_attention_bwd.py``.

Layout: q (B, Tq, H, Dh), k and v (B, Tk, Hkv, Dh), H a multiple of Hkv;
query head h reads kv head ``h // (H // Hkv)``. The kernel reads the
tensors in place through their strides (no (B*H, T, Dh) transposes), for
Dh in ``HEAD_DIMS``, fp32 or bf16, any T: ragged tiles are masked. The
reference's tile sizes (``bq``, ``bk``) and ``interpret`` do not change the
function and are not part of these signatures.

Design (H100 SXM: 67 TFLOP/s fp32 FMA): the kernel computes in fp32 FMAs
from shared memory, so it is bound by operations; see ``csrc/flash.cu``.

A wrapper given CPU tensors runs its plain version (``ref.py``); given
CUDA tensors it launches its kernel or raises. ``<wrapper>.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .launch import launch
from .launch import on_cpu as _on_cpu
from .launch import ptr as _ptr

__all__ = ["flash_attention", "flash_fwd", "KERNELS", "HEAD_DIMS"]

#: Head widths the kernels are built for.
HEAD_DIMS = (32, 64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load("flash")
    if not getattr(lib, "_typed", False):
        dims = [_I] * 8                    # B, Tq, Tk, H, Hkv, D, causal, dtype
        lib.repro_flash_fwd.argtypes = [_P] * 5 + dims + [_L] * 9 + [_P]
        lib.repro_flash_dq.argtypes = [_P] * 7 + dims + [_L] * 12 + [_P]
        lib.repro_flash_dkv.argtypes = [_P] * 8 + dims + [_L] * 12 + [_P]
        for fn in (lib.repro_flash_fwd, lib.repro_flash_dq, lib.repro_flash_dkv):
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [_I]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _head_major(t: torch.Tensor) -> torch.Tensor:
    """t itself when its head dimension is contiguous, else a copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def strides(t: torch.Tensor) -> list[int]:
    """Batch, time and head strides of a (B, T, heads, Dh) tensor."""
    return [t.stride(0), t.stride(1), t.stride(2)]


def check_qkv(q, k, v) -> tuple:
    """Validate q, k, v for the kernels; returns them with contiguous heads
    and the kernels' dims ``[B, Tq, Tk, H, Hkv, Dh]``."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Tq, H, Dh) and k, v (B, Tk, Hkv, Dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Tq, H, Dh = q.shape
    _, Tk, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != Dh or H % Hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         "match (batch, head width, H a multiple of Hkv)")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head width {Dh}: the kernels are built for "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                        "kernels take fp32 or bf16, all the same")
    if min(B, Tq, Tk) == 0:
        raise ValueError("empty attention input")
    return (_head_major(q), _head_major(k), _head_major(v),
            [B, Tq, Tk, H, Hkv, Dh])


def flash_fwd(q, k, v, *, causal: bool = True, with_lse: bool = False):
    """Attention output (B, Tq, H, Dh) in q's dtype, and when ``with_lse``
    the fp32 log-sum-exp rows (B, H, Tq), else None."""
    if _on_cpu(q, k, v):
        o, lse = ref.flash_fwd(q, k, v, causal)
        return o, (lse if with_lse else None)
    q, k, v, dims = check_qkv(q, k, v)
    B, Tq, _, H, _, Dh = dims
    o = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    launch(_lib(), flash_fwd, "repro_flash_fwd", q.device, _ptr(q), _ptr(k),
           _ptr(v), _ptr(o), _ptr(lse) if with_lse else _P(None), *dims,
           int(causal), _DTYPE_CODE[q.dtype], *strides(q), *strides(k),
           *strides(v))
    return o, lse


def flash_attention(q, k, v, *, causal: bool = True):
    """softmax(q k^T / sqrt(Dh)) v with GQA, (B, Tq, H, Dh) in q's dtype.

    CPU tensors run ``ref.flash_reference``; CUDA tensors the forward
    kernel, which writes no log-sum-exp rows here.
    """
    if _on_cpu(q, k, v):
        return ref.flash_reference(q, k, v, causal)
    return flash_fwd(q, k, v, causal=causal)[0]


#: The kernels of this module: launch counters live on these wrappers.
KERNELS = (flash_fwd,)
flash_fwd.launches = 0
