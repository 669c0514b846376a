"""Flash attention on Hopper: the forward kernels, with their plain version.

``flash_fwd`` replaces both ``repro/kernels/flash_attention.py:75
flash_attention`` (``_flash_kernel``) and
``repro/kernels/flash_attention_bwd.py:153 _fwd_with_stats``
(``_fwd_kernel``): one kernel writes o and, when asked, the log-sum-exp
rows the backward needs. Each input dtype has exactly one kernel, chosen
by dtype:

* bf16 runs ``csrc/flash_fwd_sm90.cu`` on the tensor cores: Q, K and V come
  by TMA (K/V through a ring of shared-memory stages that a producer warp
  keeps full), S = Q K^T and
  O += P V are ``wgmma`` products with fp32 sums, and P enters the second
  product from registers, rounded to bf16 (the one place it rounds unlike
  the reference, which multiplies fp32 P). On an H100 bytes bound it at
  gpt2-2.5b widths and operations at qwen2-0.5b widths. ``sm90_plan``
  states its tiles, swizzle and shared memory per head width;
* fp32 runs ``flash_fwd_kernel<float, D>`` of ``csrc/flash.cu``, fp32 FMAs
  from shared memory: ``wgmma`` has no fp32 mode, and TF32 keeps about
  three decimal digits, short of the 1e-5 bar fp32 is held to.

The backward kernels, split by dtype the same way, are in
``flash_attention_bwd.py``.

Layout: q (B, Tq, H, Dh), k and v (B, Tk, Hkv, Dh), H a multiple of Hkv;
query head h reads kv head ``h // (H // Hkv)``. The kernels read the
tensors in place through their strides (no (B*H, T, Dh) transposes), for
Dh in ``HEAD_DIMS``, any T: ragged tiles are masked. The reference's tile
sizes (``bq``, ``bk``) and ``interpret`` do not change the function and are
not part of these signatures.

A wrapper given CPU tensors runs its plain version (``ref.py``); given
CUDA tensors it launches its kernel or raises. ``<wrapper>.launches``
counts kernel launches; ``flash_fwd.launches_by_kernel`` splits the
forward's by kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import ClassVar

import torch

from . import build, ref
from .launch import launch
from .launch import on_cpu as _on_cpu
from .launch import ptr as _ptr

__all__ = ["flash_attention", "flash_fwd", "KERNELS", "HEAD_DIMS", "Sm90Plan",
           "sm90_plan", "tma_strides"]

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


def _sm90_lib() -> ctypes.CDLL:
    lib = build.load("flash_fwd_sm90")
    if not getattr(lib, "_typed", False):
        # q, k, v, o, lse; B, Tq, Tk, H, Hkv, D, causal; 9 strides; the plan
        # (Sm90Plan.c_args); the stream
        lib.repro_flash_fwd_sm90.argtypes = ([_P] * 5 + [_I] * 7 + [_L] * 9
                                             + [_I] * 6 + [_P])
        lib.repro_flash_fwd_sm90.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [_I]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


#: Shared memory a block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448


@dataclasses.dataclass(frozen=True)
class _Chunked:
    """How the Hopper kernels keep a bf16 tile of Dh columns in shared
    memory (``csrc/sm90_common.cuh``, ``Chunking<D>``): column chunks of one
    swizzle span, one TMA box each."""
    dh: int

    @property
    def swizzle(self) -> int:
        """128-byte spans where Dh divides into them (64, 128), else 64."""
        return 128 if self.dh % 64 == 0 else 64

    @property
    def chunk_cols(self) -> int:
        return self.swizzle // 2

    @property
    def chunks(self) -> int:
        return self.dh // self.chunk_cols


@dataclasses.dataclass(frozen=True)
class Sm90Plan(_Chunked):
    """Tiles of the bf16 forward (``csrc/flash_fwd_sm90.cu``) at one Dh.

    A block of two consumer warpgroups and a producer warp owns
    ``block_m`` query rows; key and value tiles of ``block_n`` rows pass
    through a ring of ``stages``, the deepest (up to 4) that fits.
    Each tile sits in shared memory as column chunks of one swizzle span
    (``swizzle`` bytes a row, ``chunk_cols`` columns), one TMA box
    ``box_q`` / ``box_kv`` each, over the 4-D view (Dh, heads, T, B). The
    kernel is built with the same numbers and refuses a launch that
    states others.
    """
    block_m: ClassVar[int] = 128
    block_n: ClassVar[int] = 128
    threads: ClassVar[int] = 288
    max_stages: ClassVar[int] = 4

    @property
    def box_q(self) -> tuple:
        return (self.chunk_cols, 1, self.block_m, 1)

    @property
    def box_kv(self) -> tuple:
        return (self.chunk_cols, 1, self.block_n, 1)

    def _smem(self, stages: int) -> int:
        return (1024 + 2 * self.block_m * self.dh
                + stages * 2 * 2 * self.block_n * self.dh + 128)

    @property
    def stages(self) -> int:
        """The deepest K/V ring, 2 to ``max_stages``, within SMEM_LIMIT."""
        return max([2] + [s for s in range(2, self.max_stages + 1)
                          if self._smem(s) <= SMEM_LIMIT])

    @property
    def smem_bytes(self) -> int:
        """Q, the K/V ring, 128 bytes of mbarriers and 1024 of alignment."""
        return self._smem(self.stages)

    def c_args(self) -> list[int]:
        return [self.block_m, self.block_n, self.threads, self.swizzle,
                self.stages, self.smem_bytes]


def check_head_width(dh: int) -> None:
    if dh not in HEAD_DIMS:
        raise ValueError(f"head width {dh}: the kernels are built for "
                         f"{HEAD_DIMS}")


def sm90_plan(dh: int) -> Sm90Plan:
    """The bf16 forward's plan at head width ``dh`` (one of ``HEAD_DIMS``)."""
    check_head_width(dh)
    plan = Sm90Plan(dh)
    assert plan.smem_bytes <= SMEM_LIMIT, plan
    return plan


def tma_strides(ptr: int, shape, strides, itemsize: int = 2):
    """(b, t, h) element strides of a (B, T, heads, Dh) tensor as its TMA
    map takes them, or None when TMA cannot read it in place.

    TMA needs a 16-byte-aligned base, a contiguous head dimension and the
    other strides positive multiples of 16 bytes below 2**40. A dimension
    of size 1 is never stepped over, so its stride is set to Dh.
    """
    if ptr % 16 or strides[3] != 1:
        return None
    out = []
    for size, stride in zip(shape[:3], strides[:3]):
        if size == 1:
            stride = shape[3]
        if stride <= 0 or (stride * itemsize) % 16 or stride * itemsize >= 1 << 40:
            return None
        out.append(stride)
    return out


def _tma_view(t: torch.Tensor) -> tuple:
    """(t, its TMA strides): t itself when TMA reads it in place, else a
    fresh contiguous copy (the callers' (B, T, H, Dh) tensors and their
    slices of a fused projection never need one)."""
    st = tma_strides(t.data_ptr(), t.shape, t.stride(), t.element_size())
    if st is None:
        t = t.clone(memory_format=torch.contiguous_format)
        st = tma_strides(t.data_ptr(), t.shape, t.stride(), t.element_size())
    return t, st


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
    check_head_width(Dh)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                        "kernels take fp32 or bf16, all the same")
    if min(B, Tq, Tk) == 0:
        raise ValueError("empty attention input")
    return (_head_major(q), _head_major(k), _head_major(v),
            [B, Tq, Tk, H, Hkv, Dh])


def flash_fwd(q, k, v, *, causal: bool = True, with_lse: bool = False):
    """Attention output (B, Tq, H, Dh) in q's dtype, and when ``with_lse``
    the fp32 log-sum-exp rows (B, H, Tq), else None.

    On CUDA, bf16 inputs launch the tensor-core kernel
    (``csrc/flash_fwd_sm90.cu``) and fp32 inputs the fp32 kernel
    (``csrc/flash.cu``); there is no other path. The bf16 kernel reads q,
    k and v through TMA, which needs a 16-byte-aligned base and strides in
    multiples of 16 bytes: a tensor that breaks that is copied to a
    contiguous one first.
    """
    if _on_cpu(q, k, v):
        o, lse = ref.flash_fwd(q, k, v, causal)
        return o, (lse if with_lse else None)
    q, k, v, dims = check_qkv(q, k, v)
    B, Tq, _, H, _, Dh = dims
    o = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lse_ptr = _ptr(lse) if with_lse else _P(None)
    if q.dtype == torch.bfloat16:
        plan = sm90_plan(Dh)
        (q, sq), (k, sk), (v, sv) = (_tma_view(t) for t in (q, k, v))
        launch(_sm90_lib(), flash_fwd, "repro_flash_fwd_sm90", q.device,
               _ptr(q), _ptr(k), _ptr(v), _ptr(o), lse_ptr, *dims,
               int(causal), *sq, *sk, *sv, *plan.c_args())
        flash_fwd.launches_by_kernel["flash_fwd_sm90"] += 1
    else:
        launch(_lib(), flash_fwd, "repro_flash_fwd", q.device, _ptr(q),
               _ptr(k), _ptr(v), _ptr(o), lse_ptr, *dims, int(causal),
               _DTYPE_CODE[q.dtype], *strides(q), *strides(k), *strides(v))
        flash_fwd.launches_by_kernel["flash_fwd_fma"] += 1
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
#: Forward launches by kernel: bf16 (tensor cores) and fp32 (FMA).
flash_fwd.launches_by_kernel = {"flash_fwd_sm90": 0, "flash_fwd_fma": 0}
