"""The host plans of ``ef_factor_kernel`` (``kernels/lowrank.py``:
``factor_plan``, ``resident_blocks``, ``parse_factor_ptxas``) and of
``gram_schmidt_kernel`` (``gs_plan``, ``gs_smem``, ``parse_gs_ptxas``),
pure functions of shapes, dtype, addresses and the SM count, checked
without a card. ``csrc/lowrank.cu``'s ``launch_factor`` derives the k-chunk
and the load paths by the same rules, and ``gs::smem_bytes`` the shared
memory; the card tests run every path."""
import itertools
import pathlib
import re

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
    (5, 333, 4097, 130),
    # the shape groups of the MoE, qwen3-32b and phi-3-vision configs
    (256, 4096, 1536, 64), (128, 1536, 4096, 64), (2, 4096, 256, 64),
    (4, 5120, 25600, 64), (2, 25600, 5120, 64), (32, 3072, 3072, 64),
    (16, 3072, 8192, 64), (8, 8192, 3072, 64),
    # zamba2-7b at depth 28: the Mamba2 in_proj and out_proj groups
    (28, 3584, 14576, 64), (28, 7168, 3584, 64)])
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


# --------------------------------------------------------- gram_schmidt plan
# The main path's panels (E, m, r) at the smallest cluster whose slab fits
# 232,448 B: C = 2 at m = 1920 and C = 8 at m = 7680 would need 964 x 64 x
# 4 = 246,784 B. Without the card's count of resident clusters the plan
# reckons one block per SM at these slabs (123,904 B) and three at 61,440
# B: (cluster, rows per block, slab bytes, blocks).
GS_MAIN = {(32, 1920, 64): (4, 480, 122_880, 128),
           (8, 1920, 64): (8, 240, 61_440, 64),
           (8, 7680, 64): (16, 480, 122_880, 128)}
# ... and with the resident clusters read on an H100 (80GB HBM3, 700 W;
# cudaOccupancyMaxActiveClusters): 30 clusters of 4 at 127,064 B (two
# waves of 32 panels), 45 of 8 at 67,704 B, 21 of 16 at 41,144 B, 7 of 16
# at 133,304 B (the (8, 7680, 64) group takes two waves)
GS_CARD = {4: 30, 8: 45, 16: 21}
GS_MAIN_CARD = {(32, 1920, 64): (8, 1), (8, 1920, 64): (8, 1),
                (8, 7680, 64): (16, 2)}


def _card_active(m):
    return lambda c, path, rows: 7 if m == 7680 and c == 16 else GS_CARD[c]


@pytest.mark.parametrize("group", sorted(GS_MAIN))
def test_gs_plan_at_the_main_groups(group):
    e, m, r = group
    plan = lr.gs_plan(*group, SMS)
    assert (plan.cluster, plan.rows, plan.slab_bytes, plan.blocks) == GS_MAIN[group]
    assert plan.path == "shared" and plan.waves == 1
    # two mbarriers, the slab at its column stride, X[2][C][r + 1], coef[r],
    # dn[r], pre[2][r + 1], red[2][4]
    assert plan.ld == lr.gs_ld(plan.rows) and plan.ld % 8 == 4
    assert plan.smem == 16 + 4 * (plan.ld * r + 2 * (plan.cluster + 1) * (r + 1)
                                  + 2 * r + 8)
    assert plan.smem <= lr.GS_SMEM_MAX
    fit = lambda c: lr.gs_smem(True, -(-m // c), r, c) <= lr.GS_SMEM_MAX
    least = 4 if m == 1920 else 16
    assert fit(least) and not fit(least // 2)


@pytest.mark.parametrize("group", sorted(GS_MAIN_CARD))
def test_gs_plan_at_the_main_groups_with_the_cards_residency(group):
    e, m, r = group
    plan = lr.gs_plan(*group, SMS, active=_card_active(m))
    assert (plan.cluster, plan.waves) == GS_MAIN_CARD[group]
    assert plan.rows == -(-m // plan.cluster) and plan.path == "shared"


def _block_rows(plan, m):
    return [max(0, min(plan.rows, m - c * plan.rows)) for c in range(plan.cluster)]


@pytest.mark.parametrize("shape", [(3, 1001, 24), (1, 1000, 24)])
def test_gs_plan_ragged_m(shape):
    """m is not a multiple of the rows per block: every block but the last
    owns ``rows`` rows, the last the rest, and together they cover m once;
    the last 16-byte chunk of a block is part pad."""
    e, m, r = shape
    plan = lr.gs_plan(*shape, SMS)
    assert plan.cluster == 8 and plan.path == "shared"
    rows = _block_rows(plan, m)
    assert sum(rows) == m and rows[:-1] == [plan.rows] * 7
    assert 0 < rows[-1] <= plan.rows and plan.blocks == 8 * e
    assert any(n % 4 for n in rows) and plan.ld >= 4 * -(-plan.rows // 4)


@pytest.mark.parametrize("shape", [(1, 1920, 1), (2, 1000, 1), (8, 7680, 1)])
def test_gs_plan_rank_one(shape):
    e, m, r = shape
    plan = lr.gs_plan(*shape, SMS)
    assert plan.path == "shared" and plan.cluster == 8
    assert plan.smem == 16 + 4 * (plan.ld + 2 * 9 * 2 + 2 + 8)
    assert sum(_block_rows(plan, m)) == m


@pytest.mark.parametrize("shape,rows", [
    ((1, 7680, 128), 480),     # 484 x 128 x 4 = 247,808 B at C = 16
    ((1, 16384, 64), 1024),    # the 4 MiB routing limit: 263,168 B
    ((1, 1 << 20, 1), 65536)])
def test_gs_plan_device_path_for_panels_past_shared_memory(shape, rows):
    e, m, r = shape
    plan = lr.gs_plan(*shape, SMS)
    assert plan.path == "device" and plan.cluster == 16 and plan.rows == rows
    assert lr.gs_smem(True, rows, r, 16) > lr.GS_SMEM_MAX
    assert plan.smem == lr.gs_smem(False, rows, r, 16) == 16 + 4 * (
        2 * 17 * (r + 1) + 2 * r + 8)
    assert plan.slab_bytes == 4 * rows * r


def test_gs_plan_more_panels_than_sms_take_waves():
    plan = lr.gs_plan(64, 1920, 64, SMS)
    assert plan.cluster == 4 and plan.blocks == 256 > SMS
    assert plan.active == SMS // 4 and plan.waves == 2
    # with the card's count of resident clusters: 45 of 8 hold 64 panels
    # in two waves, with fewer blocks per SM than 16
    plan = lr.gs_plan(64, 1920, 64, SMS, active=_card_active(1920))
    assert plan.cluster == 8 and plan.active == 45 and plan.waves == 2


def test_gs_plan_takes_the_fewest_waves():
    """Where the least cluster size leaves a second wave, a larger one that
    keeps one wins; among one-wave sizes, the fewest blocks per SM, then the
    one nearest 8."""
    asked = []

    def active(c, path, rows):
        asked.append((c, path, rows))
        return {4: 30, 8: 45, 16: 21}[c]
    plan = lr.gs_plan(32, 1920, 64, SMS, active=active)
    assert (plan.cluster, plan.rows, plan.waves, plan.active) == (8, 240, 1, 45)
    assert asked == [(4, "shared", 480), (8, "shared", 240), (16, "shared", 120)]
    # only C = 16 fits at m = 7680: two waves of 7
    plan = lr.gs_plan(8, 7680, 64, SMS, active=lambda *a: 7)
    assert (plan.cluster, plan.waves) == (16, 2)


def test_gs_plan_refuses_a_cluster_that_is_never_resident():
    with pytest.raises(RuntimeError, match="resident"):
        lr.gs_plan(8, 7680, 64, SMS, active=lambda *a: 0)
    # 4 and 16 are as near 8: the larger
    plan = lr.gs_plan(8, 1920, 64, SMS, active=lambda c, *a: 0 if c == 8 else 9)
    assert plan.cluster == 16 and plan.waves == 1


@pytest.mark.parametrize("shape,cluster,path,rows", [
    ((8, 7680, 64), 8, "device", 960), ((8, 7680, 64), 16, "shared", 480),
    ((32, 1920, 64), 16, "shared", 120), ((32, 1920, 64), 1, "device", 1920),
    ((1, 5, 3), 16, "shared", 1)])
def test_gs_plan_forced_cluster(shape, cluster, path, rows):
    plan = lr.gs_plan(*shape, SMS, cluster=cluster)
    assert (plan.cluster, plan.path, plan.rows) == (cluster, path, rows)
    assert plan.blocks == shape[0] * cluster


@pytest.mark.parametrize("shape,cluster,path", [
    ((8, 7680, 64), 16, "device"), ((8, 1920, 64), 8, "device"),
    ((8, 1920, 64), 8, "shared"), ((1, 1000, 24), 1, "device")])
def test_gs_plan_forced_path(shape, cluster, path):
    plan = lr.gs_plan(*shape, SMS, cluster=cluster, path=path)
    assert (plan.cluster, plan.path) == (cluster, path)
    assert plan.smem == lr.gs_smem(path == "shared", plan.rows, shape[2], cluster)


@pytest.mark.parametrize("shape,kwargs", [
    ((8, 7680, 64), dict(cluster=8, path="shared")),   # 246,784 B of slab
    ((8, 1920, 64), dict(path="device")),              # a path needs a size
    ((8, 1920, 64), dict(cluster=8, path="global"))])
def test_gs_plan_refuses_a_forced_path(shape, kwargs):
    with pytest.raises(ValueError):
        lr.gs_plan(*shape, SMS, **kwargs)


@pytest.mark.parametrize("m", [1, 2, 3, 17, 31, 32, 33, 100])
def test_gs_plan_keeps_two_rows_a_block_while_growing(m):
    plan = lr.gs_plan(1, m, 4, SMS)
    assert plan.cluster == 1 or 2 * plan.cluster <= m
    rows = _block_rows(plan, m)
    assert sum(rows) == m and rows[0] == plan.rows == -(-m // plan.cluster)


@pytest.mark.parametrize("num_e", [1, 2, 5, 8, 9, 33, 64, 200])
@pytest.mark.parametrize("m", [8, 1000, 1920, 4096, 7680, 16384])
@pytest.mark.parametrize("r", [1, 8, 24, 64, 128])
def test_gs_plan_rules_hold(num_e, m, r):
    plan = lr.gs_plan(num_e, m, r, SMS)
    c = plan.cluster
    assert c in lr.GS_CLUSTERS and plan.rows == -(-m // c)
    assert plan.blocks == num_e * c and plan.ld == lr.gs_ld(plan.rows)
    assert plan.ld % 8 == 4 and plan.ld >= plan.rows
    assert plan.smem == lr.gs_smem(plan.path == "shared", plan.rows, r, c)
    assert plan.smem <= lr.GS_SMEM_MAX
    fits = [k for k in lr.GS_CLUSTERS
            if lr.gs_smem(True, -(-m // k), r, k) <= lr.GS_SMEM_MAX]
    assert (plan.path == "shared") == bool(fits)
    least = fits[0] if fits else 1
    assert c == least or (c > least and 2 * c <= m)
    # no other size the plan may take has fewer waves of resident clusters
    for k in lr.GS_CLUSTERS:
        if k == least or (k > least and 2 * k <= m):
            other = lr.gs_plan(num_e, m, r, SMS, cluster=k)
            assert other.waves >= plan.waves


@pytest.mark.parametrize("shape", [(0, 64, 8), (1, 0, 8), (1, 64, 0),
                                   (-1, 64, 8), (2**30, 1920, 64),
                                   (1, 2**26, 64), (1, 64, 40_000)])
def test_gs_plan_refuses_a_shape(shape):
    with pytest.raises(ValueError):
        lr.gs_plan(*shape, SMS)


@pytest.mark.parametrize("cluster", [0, 3, 32])
def test_gs_plan_refuses_a_cluster_size(cluster):
    with pytest.raises(ValueError, match="cluster"):
        lr.gs_plan(1, 64, 8, SMS, cluster=cluster)


@pytest.mark.parametrize("rows,ld", [(1, 4), (4, 4), (5, 12), (8, 12),
                                     (12, 12), (13, 20), (120, 124),
                                     (240, 244), (480, 484), (1024, 1028)])
def test_gs_ld_is_whole_chunks_at_4_mod_8(rows, ld):
    """Whole 16-byte chunks of four rows per column, and an odd number of
    them, so the 4-row x 8-column tiles of the transposing load and store
    hit 32 banks: columns k = 0..7 start k ld mod 32 = 0, 4, ..., 28."""
    assert lr.gs_ld(rows) == ld
    assert sorted(k * ld % 32 for k in range(8)) == list(range(0, 32, 4))


_GS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119gram_schmidt_kernelILb1EEEvPKfPfS3_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119gram_schmidt_kernelILb1EEEvPKfPfS3_iiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119gram_schmidt_kernelILb0EEEvPKfPfS3_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119gram_schmidt_kernelILb0EEEvPKfPfS3_iiif
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 38 registers, 412 bytes cmem[0]
"""


def test_parse_gs_ptxas_reads_each_instance():
    got = lr.parse_gs_ptxas(_GS_LOG + _LOG)
    assert got == {
        "shared": {"registers": 40, "spill_stores": 0, "spill_loads": 0,
                   "smem": 0},
        "device": {"registers": 38, "spill_stores": 4, "spill_loads": 4,
                   "smem": 0}}
    # each reader sees only its own kernel's instances
    assert set(lr.parse_factor_ptxas(_GS_LOG + _LOG)) == {
        ("float32", False, True), ("bfloat16", True, False)}


# qwen3-moe-235b-a22b at depth 1: gate and up of 128 experts, and down
MOE_GROUPS = [(256, 4096, 1536, 64), (128, 1536, 4096, 64)]


@pytest.mark.parametrize("group", MOE_GROUPS)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plans_at_the_moe_groups_keep_the_grid_limit(group, trans, dtype):
    """At E = 256 the grid's z dimension (E x splits) bounds splits to 255;
    the plan keeps well inside it and refuses a forced count past it."""
    e, m, n, r = group
    plan = lr.factor_plan(*group, dtype, SMS, trans=trans)
    assert plan.grid[2] == e * plan.splits <= 65535
    assert plan.grid == (-(-(n if trans else m) // 128), 1, e * plan.splits)
    assert plan.vector and plan.f_vector
    most = 65535 // e
    assert lr.factor_plan(*group, dtype, SMS, trans=trans,
                          splits=most).grid[2] <= 65535
    with pytest.raises(ValueError, match="65535"):
        lr.factor_plan(*group, dtype, SMS, trans=trans, splits=most + 1)


def test_auto_plan_never_passes_the_grid_limit():
    """Many stacked slices on a short depth: the plan's own split count
    stays at or under 65535 / E."""
    for e in (255, 256, 4000, 30000, 65535):
        plan = lr.factor_plan(e, 8, 8192, 8, torch.float32, SMS, trans=False)
        assert plan.grid[2] == e * plan.splits <= 65535


# ------------------------------------------------ 64-bit element offsets
CU = (pathlib.Path(lr.__file__).parent / "csrc" / "lowrank.cu").read_text()
# the kernels' pointers into device memory (parameters and their offsets)
GLOBAL_PTRS = ("g", "e", "f", "p", "q", "out", "partial", "ghat", "err_out",
               "work", "G", "E", "Eb", "F", "P", "Q", "O")
# products that index shared memory through a pointer of the same name:
# ordered_sum's p[c * stride], the cluster's partials (<= 16 x 65 floats)
SHARED_INDEXING = {"c * stride"}


def _products_without_size_t(src: str) -> list[str]:
    """Every product in an offset of a device pointer (``ptr + expr`` or
    ``ptr[expr]``) whose leftmost factor is neither a ``(size_t)`` cast nor
    a variable declared ``size_t``: an ``int`` product that wraps past
    2**31 elements."""
    wide = set(re.findall(r"\bsize_t\s+(\w+)\s*=", src))
    names = "|".join(GLOBAL_PTRS)
    bad = []
    for line in src.splitlines():
        code = line.split("//")[0]
        for hit in re.finditer(rf"(?<![\w.])({names})\s*(\+|\[)", code):
            rest = code[hit.end():]
            depth, end = 0, len(rest)
            for i, ch in enumerate(rest):       # the offset expression
                if ch in "([":
                    depth += 1
                elif ch in ")]":
                    if depth == 0:
                        end = i
                        break
                    depth -= 1
                elif ch in ",;?:" and depth == 0:
                    end = i
                    break
            expr = rest[:end]
            for term in re.split(r"\+(?![^()]*\))", expr):
                term = term.strip()
                if "*" not in term:
                    continue
                if term in SHARED_INDEXING:
                    continue
                lead = term.lstrip(" (")
                name = re.match(r"\w+", lead)
                if not lead.startswith("size_t)") and (
                        name is None or name.group(0) not in wide):
                    bad.append(term)
    return bad


def test_lowrank_cu_offsets_are_size_t():
    """E m n passes 2**31 at a depth-2 MoE group (3.2e9 elements): every
    element offset into device memory in ``csrc/lowrank.cu`` is 64-bit."""
    assert _products_without_size_t(CU) == []
    checked = len(re.findall(r"\(size_t\)", CU))
    assert checked >= 20


@pytest.mark.parametrize("seeded", [
    "const T* G = g + be * mn;",
    "float* O = out + (sp * num_e + be) * rows * r;",
    "x = P[(row0 + rr) * r + gc];",
    "ghat[base + row * n + col] = v;"])
def test_offset_check_finds_an_int_product(seeded):
    assert _products_without_size_t(seeded)


# zamba2-7b at depth 28 (4 groups of 7): in_proj (3584 x 14576) and
# out_proj (7168 x 3584) of 28 Mamba2 layers
ZAMBA_GROUPS = [(28, 3584, 14576, 64), (28, 7168, 3584, 64)]


@pytest.mark.parametrize("group", ZAMBA_GROUPS)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plans_at_the_zamba_groups(group, trans, dtype):
    """Both products take the 16-byte paths, their splits cover the depth
    and the grid stays inside its limit."""
    e, m, n, r = group
    plan = lr.factor_plan(*group, dtype, SMS, trans=trans)
    depth = m if trans else n
    assert plan.vector and plan.f_vector
    assert plan.grid == (-(-(n if trans else m) // 128), 1, e * plan.splits)
    assert _chunks(plan, depth)[-1][1] == depth


@pytest.mark.parametrize("m", [3584, 7168, 14576])
def test_zamba_panels_take_gram_schmidt_under_4_mib(m):
    """The P panels of Zamba2's groups (m = 3584 and 7168, r = 64) and a
    14576 x 64 panel (3.73 MB, the width of in_proj's Q factor) are under
    the 4 MiB limit past which ``ops`` hands a panel to ``linalg.qr``: all
    three take the Gram-Schmidt kernel, the widest on the device-memory
    slab."""
    from repro_torch.kernels import ops
    assert not ops._use_qr(m, 64) and m * 64 * 4 <= 4 << 20
    plan = lr.gs_plan(28, m, 64, SMS)
    assert plan.path == ("device" if m == 14576 else "shared")
    assert plan.rows * plan.cluster >= m
    assert plan.smem <= lr.GS_SMEM_MAX
