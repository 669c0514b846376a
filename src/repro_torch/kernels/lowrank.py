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
* ``gram_schmidt_panel`` replaces ``:288 gram_schmidt_panel_batched`` (and
  ``:155``): classical Gram-Schmidt, eps 1e-8, as ``_gs3_kernel`` computes
  it. What bounds it is not bytes (the panel crosses device memory once
  each way) but its column chain: r columns, each needing sums over all m
  rows, so its time is r times one step's latency. The TPU kept the whole
  panel (up to 4 MiB) in VMEM. The first Hopper kernel ran one block per
  panel on a copy in L2, re-reading it for every column on at most 32 of
  the 132 SMs. Now each panel is one thread-block cluster of C <= 16
  blocks (``gs_plan``), the panel split by rows over the blocks' shared
  memory, and each column costs one exchange: every block stores its
  partial sums into every block's shared memory (``st.async`` counted on
  the receiver's mbarrier, no cluster barrier), and each sums them in
  block order. The columns are normalized at the end (the coefficients
  carry 1 / d^2), and four warps compute the next column's older dot
  products while four wait, sum and update. Panels that do not fit at C =
  16 run the same kernel on a device-memory slab.

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
           "resident_blocks", "parse_factor_ptxas", "GSPlan", "gs_plan",
           "gs_smem", "gs_ld", "parse_gs_ptxas"]

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
        lib.repro_gram_schmidt.argtypes = [_P, _P, _P] + [_I] * 6 + [
            ctypes.c_float, _P]
        lib.repro_gs_occupancy.argtypes = [_I] * 4 + [_P]
        for fn in (lib.repro_lowrank_p, lib.repro_lowrank_q,
                   lib.repro_decompress_residual, lib.repro_gram_schmidt,
                   lib.repro_gs_occupancy):
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


def _parse_ptxas(log: str, entry: re.Pattern, key) -> dict:
    """Registers, spill bytes and static shared memory of each kernel
    instance whose mangled name ``entry`` matches in a ``ptxas -v`` log,
    keyed by ``key(match)``."""
    out, k = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            hit = entry.search(line)
            k = None if hit is None else key(hit)
            if k is not None:
                out[k] = {"registers": None, "spill_stores": None,
                          "spill_loads": None, "smem": 0}
        elif k is not None and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            out[k].update({f"spill_{kind}": int(b) for b, kind in nums})
        elif k is not None and "Used" in line and "registers" in line:
            out[k]["registers"] = int(re.search(r"Used (\d+) registers",
                                                line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[k]["smem"] = int(smem.group(1)) if smem else 0
            k = None
    return out


_FACTOR_ENTRY = re.compile(r"Compiling entry function '(\S*ef_factor_kernel"
                           r"I(f|13__nv_bfloat16)Lb([01])ELb([01])E\S*)'")
_GS_ENTRY = re.compile(r"Compiling entry function "
                       r"'(\S*gram_schmidt_kernelILb([01])E\S*)'")


def parse_factor_ptxas(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each
    ``ef_factor_kernel`` instance in a ``ptxas -v`` log, keyed like
    ``FACTOR_REGS``: ``{(dtype, trans, vector): {"registers": ...,
    "spill_stores": ..., "spill_loads": ..., "smem": ...}}``."""
    return _parse_ptxas(log, _FACTOR_ENTRY, lambda hit: (
        "float32" if hit.group(2) == "f" else "bfloat16",
        hit.group(3) == "1", hit.group(4) == "1"))


def parse_gs_ptxas(log: str) -> dict:
    """The same for the two ``gram_schmidt_kernel`` instances, keyed by
    their path: ``{"shared": {...}, "device": {...}}``."""
    return _parse_ptxas(log, _GS_ENTRY, lambda hit: (
        "shared" if hit.group(2) == "1" else "device"))


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
    The grid's z dimension is E x splits, at most 65535: the plan never
    picks more splits than that allows, and refuses a forced count beyond
    it. Raises before any launch on what the kernel does not take.
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
        most = min(depth // MIN_CHUNK, 2 * -(-slots // blocks),
                   _MAX_GRID_YZ // num_e)
        splits = min(range(1, max(1, most) + 1),
                     key=lambda s: (-(-blocks * s // slots) / s, s))
    elif num_e * splits > _MAX_GRID_YZ:
        raise ValueError(f"E x splits = {num_e} x {splits} > {_MAX_GRID_YZ}: "
                         f"the grid's z dimension (E x splits) takes at most "
                         f"{_MAX_GRID_YZ}")
    splits = max(1, splits)
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


# gram_schmidt_kernel's shape (csrc/lowrank.cu, namespace gs)
GS_CLUSTERS = (1, 2, 4, 8, 16)     # blocks per panel; above 8 non-portable
GS_THREADS = 256                   # a block: 8 warps share a step's dot products
GS_SMEM_MAX = 232_448              # the most shared memory a Hopper block has
#: the register caps of ``__launch_bounds__(256, 3)`` (shared slabs) and
#: ``(256, 2)`` (device-memory slabs): used only to reckon resident blocks
#: where the card's count is not asked
GS_REGS = {"shared": 80, "device": 128}


def gs_ld(rows: int) -> int:
    """Column stride of a block's slab, as ``gs::ld_of``: ``rows`` rounded
    up to 4 mod 8, so each column is whole 16-byte chunks and the
    transposing load and store (4 rows x 8 columns a warp) hit 32 banks."""
    return (rows + 3) // 8 * 8 + 4


def gs_smem(shared: bool, rows: int, r: int, cluster: int) -> int:
    """Dynamic shared memory of one block, bytes, as ``gs::smem_bytes``
    computes it: two mbarriers (16 B); on the shared path the slab, ``r``
    columns of ``gs_ld(rows)`` floats; X[2][C][r + 1], every block's
    partial sums for a step (r coefficients and ||v||^2), two steps' worth;
    coef[r]; the columns' denominators dn[r]; pre[2][r + 1], this block's
    partials staged before they are sent; red[2][4], the main warps' shares
    of two sums."""
    slab = r * gs_ld(rows) if shared else 0
    return 16 + 4 * (slab + 2 * (cluster + 1) * (r + 1) + 2 * r + 8)


@dataclasses.dataclass(frozen=True)
class GSPlan:
    """One ``gram_schmidt_kernel`` launch: ``blocks`` = E x ``cluster``
    blocks of ``GS_THREADS``, block c of a cluster owning rows [c rows,
    min((c + 1) rows, m)) of its panel."""
    cluster: int
    rows: int
    path: str          # "shared": the slab in shared memory; "device": in L2
    ld: int            # the slab's column stride, floats
    smem: int          # dynamic shared memory per block, bytes
    slab_bytes: int    # rows x r x 4: the block's share of the panel
    blocks: int
    active: int        # clusters resident at once
    waves: int


def gs_plan(num_e: int, m: int, r: int, sm_count: int, *, active=None,
            cluster: int | None = None, path: str | None = None) -> GSPlan:
    """The launch of ``gram_schmidt_kernel`` for an (E, m, r) stack, a pure
    function.

    The least cluster size C is the smallest at which a block's slab (and
    its buffers) fits the 232,448 B of shared memory a block may use; the
    plan may take any larger one up to 16 with 2C <= m (every block keeps
    rows). It takes the one with the fewest waves of resident clusters,
    then the fewest blocks per SM (ceil(E C / SMs): blocks on one SM share
    its issue slots and shared-memory bandwidth), then on the shared path
    the one nearest 8 (beyond 8 a step's exchange grows faster than its
    row work shrinks; ``chip_smoke.py`` (b) times every size), then the
    largest (the device path's row work, read from L2, dominates).
    ``active(cluster, path, rows)`` gives the clusters resident at
    once (on the card, ``cudaOccupancyMaxActiveClusters``); without it they
    are reckoned from shared memory and ``GS_REGS``, as if the SMs fell
    into clusters without waste. A panel that does not fit at C = 16 takes
    the device-memory path by the same rules (C from 1). ``cluster`` forces
    a size (timing sweeps): the shared path if the slab fits there, else
    the device one; ``path`` forces the path too. Raises on what the kernel
    does not take.
    """
    if min(num_e, m, r) < 1:
        raise ValueError(f"(E, m, r) = {(num_e, m, r)}: each must be >= 1")
    if m * r > _MAX_INT:
        raise ValueError(f"an ({m}, {r}) panel has over 2**31 - 1 elements")
    if cluster is not None and cluster not in GS_CLUSTERS:
        raise ValueError(f"cluster {cluster}: want one of {GS_CLUSTERS}")
    if path not in (None, "shared", "device") or (path and cluster is None):
        raise ValueError(f"path {path!r}: want 'shared' or 'device', with a cluster")

    def shape(c: int, shared: bool):
        rows = -(-m // c)
        return rows, gs_smem(shared, rows, r, c)

    fits = lambda c: shape(c, True)[1] <= GS_SMEM_MAX
    if cluster is not None:
        shared, sizes = fits(cluster) if path is None else path == "shared", [cluster]
        if shared and not fits(cluster):
            raise ValueError(f"an ({m}, {r}) panel's slab does not fit shared "
                             f"memory at cluster {cluster}")
    else:
        least = next((c for c in GS_CLUSTERS if fits(c)), None)
        shared = least is not None
        least = least or 1
        sizes = [c for c in GS_CLUSTERS if c == least or (c > least and 2 * c <= m)]
    if shape(sizes[0], False)[1] > GS_SMEM_MAX:
        raise ValueError(f"r = {r}: the kernel's buffers exceed shared memory")
    if num_e * sizes[0] > _MAX_INT:
        raise ValueError(f"E = {num_e}: the grid holds at most {_MAX_INT} "
                         f"blocks, E x {sizes[0]} asked")
    path = "shared" if shared else "device"
    best, best_key = None, None
    for c in sizes:
        rows, smem = shape(c, shared)
        act = (active(c, path, rows) if active is not None else
               sm_count * resident_blocks(GS_REGS[path], smem, GS_THREADS) // c)
        if act < 1:
            continue
        waves = -(-num_e // act)
        near8 = abs(c.bit_length() - 4) if shared else 0
        key = (waves, -(-num_e * c // sm_count), near8, -c)
        if best is None or key < best_key:
            best_key = key
            best = GSPlan(cluster=c, rows=rows, path=path, ld=gs_ld(rows),
                          smem=smem, slab_bytes=4 * rows * r,
                          blocks=num_e * c, active=act, waves=waves)
    if best is None:
        raise RuntimeError(f"no cluster of {sizes} blocks with {path} slabs "
                           f"can be resident for an ({m}, {r}) panel")
    return best


_GS_OCCUPANCY: dict = {}


def _gs_active(device: torch.device, cluster: int, path: str, rows: int,
               r: int) -> int:
    """Clusters of that launch resident at once on ``device``, from
    ``repro_gs_occupancy`` (cached); raises where the C side's shared
    memory or column stride differs from ``gs_smem`` or ``gs_ld``."""
    key = (str(device), cluster, path, rows, r)
    if key not in _GS_OCCUPANCY:
        out = (ctypes.c_int * 3)()
        shared = path == "shared"
        with torch.cuda.device(device):
            rc = _lib().repro_gs_occupancy(int(shared), cluster, rows, r,
                                           ctypes.cast(out, _P))
        if rc != 0:
            msg = _lib().repro_cuda_error_string(rc).decode()
            raise RuntimeError(f"repro_gs_occupancy failed: {msg} ({rc})")
        want = gs_smem(shared, rows, r, cluster), gs_ld(rows)
        if tuple(out[1:]) != want:
            raise RuntimeError(f"gram_schmidt_kernel takes {tuple(out[1:])} "
                               f"(shared memory, column stride), the plan {want}")
        _GS_OCCUPANCY[key] = out[0]
    return _GS_OCCUPANCY[key]


def _gs_plan_for(p: torch.Tensor, cluster: int | None = None,
                 path: str | None = None) -> GSPlan:
    """``gs_plan`` for a CUDA stack, with the card's SM count and resident
    clusters."""
    num_e, m, r = p.shape
    return gs_plan(
        num_e, m, r,
        torch.cuda.get_device_properties(p.device).multi_processor_count,
        active=lambda c, where, rows: _gs_active(p.device, c, where, rows, r),
        cluster=cluster, path=path)


def _launch_gs(p, eps: float = 1e-8, cluster: int | None = None,
               path: str | None = None):
    """Launch ``gram_schmidt_kernel`` on a CUDA stack as ``gs_plan``
    decides; counts the launch. ``cluster`` and ``path`` force the plan's
    size and path (timing sweeps)."""
    if p.ndim != 3:
        raise ValueError(f"want an (E, m, r) stack, got {tuple(p.shape)}")
    p = p.to(F32).contiguous()
    out = torch.empty_like(p)
    if p.numel() == 0:
        return out
    num_e, m, r = p.shape
    plan = _gs_plan_for(p, cluster, path)
    work = (torch.empty((num_e * plan.cluster, r, plan.ld), dtype=F32,
                        device=p.device) if plan.path == "device" else None)
    _launch(gram_schmidt_panel, "repro_gram_schmidt", p.device, _ptr(p),
            _ptr(out), _P(None) if work is None else _ptr(work), num_e, m, r,
            plan.cluster, plan.rows, int(plan.path == "shared"), eps)
    return out


def gram_schmidt_panel(p, eps: float = 1e-8):
    """Orthonormal columns for each slice of an (E, m, r) stack, fp32."""
    if _on_cpu(p):
        return plain_gram_schmidt(p, eps)
    return _launch_gs(p, eps)


#: The kernels of this module: launch counters live on these wrappers.
KERNELS = (ef_lowrank_p, ef_lowrank_q, decompress_residual, gram_schmidt_panel)
for _fn in KERNELS:
    _fn.launches = 0
del _fn
