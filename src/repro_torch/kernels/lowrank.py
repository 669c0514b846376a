"""Hopper kernels for the PowerSGD hot spots, with their plain versions.

The CUDA C++ lives in ``csrc/lowrank.cu`` (built by ``build.py``, loaded
with ``ctypes``). Every wrapper takes batched ``(E, ...)`` stacks, which is
what the bucketed executor hands it; the 2-D per-leaf forms are E = 1
(``ops.py``). A wrapper given CPU tensors runs its plain version; given
CUDA tensors it launches its kernel or raises. ``<wrapper>.launches``
counts kernel launches.

Design notes, per kernel (H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32 FMA):

* ``ef_lowrank_p`` replaces ``repro/kernels/lowrank.py:188
  ef_lowrank_p_batched`` (and ``:47``, the 2-D form). (G+E) is read once at
  2r FLOP per element: at r = 64 in fp32 that is 128 FLOP per 8 bytes, 16
  FLOP/B, just under the fp32 ridge of 20 FLOP/B, so the kernel has to keep
  the FMA pipes about 80% busy merely to keep pace with memory. The TPU
  kernel summed over n on its sequential grid axis; Hopper blocks run in
  no order, so each block owns a (128 x 64) tile of P (all of r at r <= 64)
  and loops over n itself: the register-blocked SGEMM, 128 threads of 8 x 8
  accumulators, four 16-byte shared loads per 64 FMA, k-tiles (32 deep on
  the 16-byte path, whole 128-byte lines of G's rows) double-buffered:
  the next tile's G and E are loaded into registers as 16-byte vectors
  during the FMAs, added in fp32, then stored; the Q panel comes by
  cp.async. Rows that 16-byte loads cannot read take a scalar path.
  ``factor_plan`` splits the n loop only where that makes fewer waves of
  resident blocks, and a second pass sums the partials in split order (no
  atomics).
* ``ef_lowrank_q`` replaces ``:218 ef_lowrank_q_batched`` (and ``:78``):
  the tall reduction over m, with the same kernel (A read transposed, so
  its tile stores are straight; k-tiles of 16), the same plan and the same
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
import dataclasses
import re

import torch

from . import build, ref
from .launch import launch
from .launch import on_cpu as _on_cpu
from .launch import ptr as _ptr

__all__ = ["ef_lowrank_p", "ef_lowrank_q", "decompress_residual",
           "gram_schmidt_panel", "KERNELS", "plain_gram_schmidt",
           "FactorPlan", "factor_plan", "factor_k_tile", "factor_smem",
           "resident_blocks", "parse_factor_ptxas"]

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


# ef_factor_kernel's shape (csrc/lowrank.cu, namespace factor)
FACTOR_THREADS = 128
FACTOR_TILE = (128, 64)     # output rows x factor columns per block


def factor_k_tile(trans: bool, vector: bool) -> int:
    """Reduction depth per k-tile: 32 where P reads rows of G with 16-byte
    loads (whole 128-byte lines of each row per tile), else 16."""
    return 32 if vector and not trans else 16


def factor_smem(k_tile: int) -> int:
    """Static shared memory: two (k_tile x 128) A tiles and two
    (k_tile x 64) F tiles, fp32."""
    return 4 * 2 * k_tile * (FACTOR_TILE[0] + FACTOR_TILE[1])


#: registers per thread of each instance (dtype, trans, vector), as
#: ``ptxas -v`` reports them for ``__launch_bounds__(128, 2)``;
#: ``chip_smoke.py`` (a) holds the build log to these and to no spills.
FACTOR_REGS = {
    ("float32", False, True): 254, ("bfloat16", False, True): 245,
    ("float32", False, False): 237, ("bfloat16", False, False): 237,
    ("float32", True, True): 202, ("bfloat16", True, True): 167,
    ("float32", True, False): 243, ("bfloat16", True, False): 243,
}
#: the shallowest split: its (128 x 64) fp32 partial, written and read
#: back, is 1/4 of the bytes of G and E it reads in fp32
MIN_CHUNK = 256
_MAX_GRID_YZ = 65535
_MAX_INT = 2**31 - 1


def resident_blocks(regs: int, smem: int, threads: int = FACTOR_THREADS) -> int:
    """Blocks one Hopper SM holds at once: 65,536 registers allocated 256 to
    a warp, 228 KB of shared memory with 1 KB reserved per block, 2,048
    threads and 32 blocks."""
    warps = -(-threads // 32)
    warp_regs = -(-regs * 32 // 256) * 256
    return min(65536 // warp_regs // warps, 233472 // (smem + 1024),
               2048 // threads, 32)


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S*ef_factor_kernel"
                          r"I(f|13__nv_bfloat16)Lb([01])ELb([01])E\S*)'")


def parse_factor_ptxas(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each
    ``ef_factor_kernel`` instance in a ``ptxas -v`` log, keyed like
    ``FACTOR_REGS``: ``{(dtype, trans, vector): {"registers": ...,
    "spill_stores": ..., "spill_loads": ..., "smem": ...}}``."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            hit = _PTXAS_ENTRY.search(line)
            key = None if hit is None else (
                "float32" if hit.group(2) == "f" else "bfloat16",
                hit.group(3) == "1", hit.group(4) == "1")
            if key is not None:
                out[key] = {"registers": None, "spill_stores": None,
                            "spill_loads": None, "smem": 0}
        elif key is not None and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            out[key].update({f"spill_{kind}": int(b) for b, kind in nums})
        elif key is not None and "Used" in line and "registers" in line:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[key]["smem"] = int(smem.group(1)) if smem else 0
            key = None
    return out


@dataclasses.dataclass(frozen=True)
class FactorPlan:
    """One ``ef_factor_kernel`` launch: grid (row tiles, column tiles,
    E x splits); split s sums k in [s kchunk, min(K, (s + 1) kchunk))."""
    grid: tuple[int, int, int]
    splits: int
    kchunk: int
    k_tile: int
    vector: bool      # 16-byte loads of G and E (else one element per load)
    f_vector: bool    # 16-byte loads of the factor
    resident: int     # blocks per SM


def factor_plan(num_e: int, m: int, n: int, r: int, dtype, sm_count: int, *,
                trans: bool, ptrs=(0, 0, 0), splits: int | None = None
                ) -> FactorPlan:
    """The launch of P (``trans=False``: rows m, depth n) or Q (rows n,
    depth m) for (E, m, n) stacks at rank r, a pure function.

    ``ptrs`` are the addresses of G, E and the factor: 16-byte loads need
    n % 4 == 0 (fp32) or n % 8 == 0 (bf16) and aligned G and E, and r % 4 ==
    0 and an aligned factor; ``csrc/lowrank.cu``'s ``launch_factor`` applies
    the same rules. The reduction is split into chunks of whole k-tiles,
    no shallower than ``MIN_CHUNK`` and none empty, as many as make the
    fewest waves of resident blocks per unit of depth: the count s of 1 ..
    2 x (resident blocks / blocks) that minimises ceil(blocks s / resident)
    / s, the smallest on a tie. So a grid that fills the resident blocks is
    not split, and 120 blocks on 264 resident take 2 splits (one wave),
    not 3 (1.36 waves). ``splits`` forces a count instead (timing sweeps).
    Raises before any launch on what the kernel does not take.
    """
    name = str(dtype).removeprefix("torch.")
    if name not in ("float32", "bfloat16"):
        raise TypeError(f"dtype {dtype}: the kernels take fp32 or bf16")
    if min(num_e, m, n, r) < 1 or max(num_e, m, n, r) > _MAX_INT:
        raise ValueError(f"(E, m, n, r) = {(num_e, m, n, r)}: each must be "
                         f"in [1, 2**31)")
    if num_e > _MAX_GRID_YZ or -(-r // FACTOR_TILE[1]) > _MAX_GRID_YZ:
        raise ValueError(f"E = {num_e}, r = {r}: the grid takes E <= "
                         f"{_MAX_GRID_YZ} and r / {FACTOR_TILE[1]} <= "
                         f"{_MAX_GRID_YZ}")
    rows, depth = (n, m) if trans else (m, n)
    vec_n = 16 // (4 if name == "float32" else 2)
    g_ptr, e_ptr, f_ptr = ptrs
    vector = n % vec_n == 0 and g_ptr % 16 == 0 and e_ptr % 16 == 0
    f_vector = r % 4 == 0 and f_ptr % 16 == 0
    k_tile = factor_k_tile(trans, vector)
    resident = resident_blocks(FACTOR_REGS[(name, trans, vector)],
                               factor_smem(k_tile))
    tiles = (-(-rows // FACTOR_TILE[0]), -(-r // FACTOR_TILE[1]))
    if splits is None:
        blocks, slots = num_e * tiles[0] * tiles[1], resident * sm_count
        most = min(depth // MIN_CHUNK, 2 * -(-slots // blocks))
        splits = min(range(1, max(1, most) + 1),
                     key=lambda s: (-(-blocks * s // slots) / s, s))
    splits = max(1, min(splits, _MAX_GRID_YZ // num_e))
    chunk = lambda s: -(-(-(-depth // s)) // k_tile) * k_tile
    splits = -(-depth // chunk(splits))       # drop splits left empty
    return FactorPlan(grid=(*tiles, num_e * splits), splits=splits,
                      kchunk=chunk(splits), k_tile=k_tile, vector=vector,
                      f_vector=f_vector, resident=resident)


def _launch_factor(wrapper, fn_name: str, grad, err, f, *, trans: bool,
                   splits: int | None = None):
    """Launch the P (or Q) kernel on CUDA stacks; counts the launch on
    ``wrapper``. ``splits`` forces the plan's split count."""
    grad, err = _gradient_pair(grad, err)
    num_e, m, n = grad.shape
    r = f.shape[-1]
    f = _factor(f, (num_e, m if trans else n, r))
    rows = n if trans else m
    out = torch.empty((num_e, rows, r), dtype=F32, device=grad.device)
    if out.numel() == 0 or (m if trans else n) == 0:
        return out.zero_()
    plan = factor_plan(
        num_e, m, n, r, grad.dtype,
        torch.cuda.get_device_properties(grad.device).multi_processor_count,
        trans=trans, ptrs=(grad.data_ptr(), err.data_ptr(), f.data_ptr()),
        splits=splits)
    partial = (torch.empty((plan.splits, num_e, rows, r), dtype=F32,
                           device=grad.device) if plan.splits > 1 else out)
    _launch(wrapper, fn_name, grad.device, _ptr(grad), _ptr(err), _ptr(f),
            _ptr(out), _ptr(partial), num_e, m, n, r, plan.splits,
            _DTYPE_CODE[grad.dtype])
    return out


def ef_lowrank_p(grad, err, q):
    """P[e] = (grad[e] + err[e]) @ q[e]: (E, m, n) x (E, n, r) -> (E, m, r) fp32."""
    if _on_cpu(grad, err, q):
        return ref.ef_lowrank_p(grad, err, q)
    return _launch_factor(ef_lowrank_p, "repro_lowrank_p", grad, err, q,
                          trans=False)


def ef_lowrank_q(grad, err, p_hat):
    """Q[e] = (grad[e] + err[e])^T @ p_hat[e]: -> (E, n, r) fp32."""
    if _on_cpu(grad, err, p_hat):
        return ref.ef_lowrank_q(grad, err, p_hat)
    return _launch_factor(ef_lowrank_q, "repro_lowrank_q", grad, err, p_hat,
                          trans=True)


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
