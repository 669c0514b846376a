"""The host plan of ``ef_factor_kernel`` (``kernels/lowrank.py``:
``factor_plan``, ``resident_blocks``, ``parse_factor_ptxas``), a pure
function of shapes, dtype, addresses and the SM count, checked without a
card. ``csrc/lowrank.cu``'s ``launch_factor`` derives the k-chunk and the
load paths by the same rules; the card tests run every path."""
import itertools

import pytest
import torch

from repro_torch.kernels import lowrank as lr

SMS = 132       # H100 SXM
SMEM_16, SMEM_32 = lr.factor_smem(16), lr.factor_smem(32)


def _chunks(plan, depth):
    """The [begin, end) of each split, as the kernel computes them."""
    return [(s * plan.kchunk, min(depth, (s + 1) * plan.kchunk))
            for s in range(plan.splits)]


@pytest.mark.parametrize("num_e,m,n,r", [
    (32, 1920, 1920, 64), (8, 1920, 7680, 64), (8, 7680, 1920, 64),
    (1, 64, 7680, 8), (1, 100, 5000, 64), (1, 3000, 100, 16), (3, 1, 1, 1),
    (1, 130, 12, 8), (2, 9, 200, 16), (1, 17, 65, 3), (1, 128, 100_000, 64),
    (5, 333, 4097, 130)])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splits_cover_the_depth_in_whole_k_tiles(num_e, m, n, r, trans, dtype):
    plan = lr.factor_plan(num_e, m, n, r, dtype, SMS, trans=trans)
    depth = m if trans else n
    chunks = _chunks(plan, depth)
    KT = plan.k_tile
    assert KT == (32 if plan.vector and not trans else 16)
    assert plan.kchunk % KT == 0 and plan.kchunk > 0
    # the chunks tile [0, depth) in order, none empty
    assert chunks[0][0] == 0 and chunks[-1][1] == depth
    assert all(a < b for a, b in chunks)
    assert all(b == c for (_, b), (c, _) in zip(chunks, chunks[1:]))
    # the C side's rule: kchunk = ceil(depth / splits) in whole k-tiles
    assert plan.kchunk == -(-(-(-depth // plan.splits)) // KT) * KT
    assert plan.grid[2] == num_e * plan.splits <= 65535
    if plan.splits > 1:     # split only down to MIN_CHUNK
        assert depth // plan.splits >= lr.MIN_CHUNK - KT
        # no more than twice the splits that fill the resident blocks
        blocks = plan.grid[0] * plan.grid[1] * num_e
        assert plan.splits <= 2 * -(-plan.resident * SMS // blocks)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 7, 16, 31, 200])
@pytest.mark.parametrize("depth", [1, 15, 16, 17, 100, 1920, 4999])
def test_forced_splits_leave_no_chunk_empty(splits, depth):
    plan = lr.factor_plan(1, 64, depth, 64, torch.float32, SMS, trans=False,
                          splits=splits)
    chunks = _chunks(plan, depth)
    assert plan.splits <= splits and all(a < b for a, b in chunks)
    assert chunks[-1][1] == depth


ALIGNED = (0, 256, 4096)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 12, 77, 98, 140, 1030,
                               1920])
@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4),
                                       (torch.bfloat16, 8)])
@pytest.mark.parametrize("trans", [False, True])
def test_scalar_path_for_every_unaligned_n(n, dtype, vec, trans):
    plan = lr.factor_plan(2, 40, n, 64, dtype, SMS, trans=trans, ptrs=ALIGNED)
    assert plan.vector == (n % vec == 0)
    assert plan.f_vector


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("offset", [2, 4, 8, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_path_for_every_unaligned_pointer(which, offset, dtype):
    """G or E off 16 bytes takes the scalar path for G and E; a factor off
    16 bytes, its scalar staging."""
    ptrs = list(ALIGNED)
    ptrs[which] += offset
    plan = lr.factor_plan(2, 40, 1920, 64, dtype, SMS, trans=False, ptrs=ptrs)
    assert plan.vector == (which == 2)
    assert plan.f_vector == (which != 2)


@pytest.mark.parametrize("r", [1, 2, 3, 5, 6, 62, 66, 70])
def test_factor_staging_is_scalar_for_r_not_a_multiple_of_4(r):
    plan = lr.factor_plan(2, 40, 1920, r, torch.float32, SMS, trans=True,
                          ptrs=ALIGNED)
    assert plan.vector and plan.f_vector == (r % 4 == 0)


@pytest.mark.parametrize("regs,smem,threads,want", [
    (168, SMEM_16, 128, 3),    # 5376 registers a warp: 12 warps
    (128, SMEM_16, 128, 4),    # 16 warps
    (161, SMEM_16, 128, 3),    # allocated as 168
    (169, SMEM_16, 128, 2),    # allocated as 176: 11 warps
    (201, SMEM_16, 128, 2),    # allocated as 208: 9 warps
    (254, SMEM_32, 128, 2),
    (32, SMEM_16, 128, 9),     # shared memory: 9 x (24576 + 1024)
    (32, SMEM_32, 128, 4),     # 4 x (49152 + 1024)
    (32, 100_000, 128, 2),
    (32, 0, 128, 16),                 # 2048 threads
    (16, 0, 32, 32),                  # 32 blocks
    (64, 0, 1024, 1)])
def test_resident_blocks_follow_registers_and_shared_memory(regs, smem,
                                                            threads, want):
    assert lr.resident_blocks(regs, smem, threads) == want


def test_plan_residency_is_the_stated_registers_and_shared_memory():
    assert SMEM_16 == 2 * 16 * 128 * 4 + 2 * 16 * 64 * 4 == 24576
    assert SMEM_32 == 49152          # the most static shared memory a block has
    for (dt, trans, vec), regs in lr.FACTOR_REGS.items():
        n = 1920 if vec else 1921
        plan = lr.factor_plan(8, 1920, n, 64, getattr(torch, dt), SMS,
                              trans=trans)
        assert plan.vector == vec and regs <= 255
        assert plan.resident == lr.resident_blocks(
            regs, lr.factor_smem(plan.k_tile))
        # the register cap, __launch_bounds__(128, 2), keeps 2 blocks
        assert plan.resident >= 2


# the main path's fp32 groups (gpt2-2.5b widths, rank 64), as PERF.md states
# them: (E, m, n, r) -> (P's splits, Q's splits). 480 blocks fill the 264
# resident (2 per SM on 132) in 2 waves and are not split; 120 blocks take
# 2 splits (240 blocks, one wave), not 3 (360: 2 waves).
MAIN = {(32, 1920, 1920, 64): (1, 1), (8, 1920, 7680, 64): (2, 1),
        (8, 7680, 1920, 64): (1, 2)}


@pytest.mark.parametrize("group", sorted(MAIN))
def test_splits_at_the_main_groups(group):
    e, m, n, r = group
    for trans, want in zip((False, True), MAIN[group]):
        plan = lr.factor_plan(*group, torch.float32, SMS, trans=trans)
        assert plan.splits == want
        assert plan.vector and plan.f_vector and plan.resident == 2
        assert plan.k_tile == (16 if trans else 32)
        assert plan.grid == (-(-(n if trans else m) // 128), 1, e * want)
        assert plan.kchunk == (m if trans else n) // want


@pytest.mark.parametrize("r,tiles", [(1, 1), (2, 1), (64, 1), (65, 2),
                                     (128, 2), (129, 3), (1000, 16)])
def test_rank_above_64_takes_more_column_tiles(r, tiles):
    for trans in (False, True):
        plan = lr.factor_plan(2, 300, 500, r, torch.float32, SMS, trans=trans)
        assert plan.grid[1] == tiles
        assert plan.grid[0] == -(-(500 if trans else 300) // 128)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.int32,
                                   "float8"])
def test_plan_refuses_a_dtype(dtype):
    with pytest.raises(TypeError, match="fp32 or bf16"):
        lr.factor_plan(1, 64, 64, 8, dtype, SMS, trans=False)


@pytest.mark.parametrize("shape", [(0, 4, 4, 2), (1, 0, 4, 2), (1, 4, 4, 0),
                                   (65536, 4, 4, 2), (1, 4, 4, 64 * 65536),
                                   (1, 2**31, 4, 2)])
def test_plan_refuses_a_shape(shape):
    with pytest.raises(ValueError):
        lr.factor_plan(*shape, torch.float32, SMS, trans=False)


_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116decompress_kernelIfEEvPKfS2_PKT_S5_PS3_S6_iii' for 'sm_90a'
ptxas info    : Used 40 registers, 16640 bytes smem, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116ef_factor_kernelIfLb0ELb1EEEvPKT_S3_PKfPfiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116ef_factor_kernelIfLb0ELb1EEEvPKT_S3_PKfPfiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, 25088 bytes smem, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116ef_factor_kernelI13__nv_bfloat16Lb1ELb0EEEvPKT_S4_PKfPfiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116ef_factor_kernelI13__nv_bfloat16Lb1ELb0EEEvPKT_S4_PKfPfiiiiiii
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, 25088 bytes smem, 420 bytes cmem[0]
"""


def test_parse_factor_ptxas_reads_each_instance():
    got = lr.parse_factor_ptxas(_LOG)
    assert got == {
        ("float32", False, True): {"registers": 166, "spill_stores": 0,
                                   "spill_loads": 0, "smem": 25088},
        ("bfloat16", True, False): {"registers": 168, "spill_stores": 12,
                                    "spill_loads": 16, "smem": 25088}}
    assert set(lr.FACTOR_REGS) == set(itertools.product(
        ("float32", "bfloat16"), (False, True), (False, True)))
