"""Host-side plans of the bf16 tensor-core flash kernels, on the CPU.

``flash_attention.sm90_plan`` states the tiles, swizzle, TMA boxes and
shared memory of ``csrc/flash_fwd_sm90.cu`` per head width, and
``flash_attention_bwd.sm90_bwd_plan`` those of the dQ and dK/dV kernels of
``csrc/flash_bwd_sm90.cu`` with their register arithmetic (each kernel is
built with the same numbers and refuses a launch that states others);
``tma_strides`` says whether TMA reads a tensor in place. The kernels
themselves run only on the card (``test_torch_kernels_cuda.py``).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb

# Dh: (swizzle bytes, chunk columns, chunks)
CHUNKING = {32: (64, 32, 1), 64: (128, 64, 1), 96: (64, 32, 3),
            128: (128, 64, 2)}
# Dh: K/V ring depth, the deepest of at most 4 that fits
STAGES = {32: 4, 64: 4, 96: 4, 128: 3}


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_plan_chunks_each_row_into_whole_swizzle_spans(dh):
    plan = fa.sm90_plan(dh)
    assert (plan.swizzle, plan.chunk_cols, plan.chunks) == CHUNKING[dh]
    assert plan.chunks * plan.chunk_cols == dh
    assert plan.chunk_cols * 2 == plan.swizzle     # one bf16 box row per span
    assert plan.box_q == (plan.chunk_cols, 1, 128, 1)
    assert plan.box_kv == (plan.chunk_cols, 1, 128, 1)
    # two consumer warpgroups of 64 rows and a producer warp
    assert (plan.block_m, plan.threads) == (128, 2 * 128 + 32)


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_plan_shared_memory_fits_a_block(dh):
    plan = fa.sm90_plan(dh)
    assert plan.stages == STAGES[dh]
    tiles = 2 * dh * (plan.block_m + 2 * plan.stages * plan.block_n)
    assert plan.smem_bytes == 1024 + tiles + 128
    assert plan.smem_bytes <= fa.SMEM_LIMIT == 232_448
    deeper = 2 * dh * (plan.block_m + 2 * (plan.stages + 1) * plan.block_n)
    assert plan.stages == 4 or 1024 + deeper + 128 > fa.SMEM_LIMIT
    # every tile starts on the 1024-byte period of the 128-byte swizzle
    assert (2 * dh * plan.block_m) % 1024 == 0
    assert (2 * dh * plan.block_n) % 1024 == 0
    assert plan.c_args() == [128, 128, 288, plan.swizzle, plan.stages,
                             plan.smem_bytes]


@pytest.mark.parametrize("dh", [0, 16, 40, 80, 256])
def test_plan_refuses_other_head_widths(dh):
    with pytest.raises(ValueError, match=f"head width {dh}"):
        fa.sm90_plan(dh)


def _fused(dh, heads=4):
    """q, k and v as slices of one (B, T, 3, H, Dh) bf16 projection."""
    qkv = torch.zeros((2, 33, 3, heads, dh), dtype=torch.bfloat16)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_tma_reads_contiguous_and_fused_tensors_in_place(dh):
    t = torch.zeros((2, 33, 4, dh), dtype=torch.bfloat16)
    assert fa.tma_strides(t.data_ptr(), t.shape, t.stride()) == \
        list(t.stride()[:3])
    for view in _fused(dh):
        got = fa.tma_strides(view.data_ptr(), view.shape, view.stride())
        assert got == [33 * 3 * 4 * dh, 3 * 4 * dh, dh]


@pytest.mark.parametrize("ptr,shape,strides,want", [
    (0, (2, 64, 4, 64), (16384, 256, 64, 1), [16384, 256, 64]),
    (8, (2, 64, 4, 64), (16384, 256, 64, 1), None),         # base off 16 B
    (16, (2, 64, 4, 64), (16384, 256, 64, 1), [16384, 256, 64]),
    (0, (2, 64, 4, 36), (9216, 144, 36, 1), None),          # 72-byte heads
    (0, (2, 64, 4, 32), (8192, 128, 32, 2), None),          # Dh not contiguous
    (0, (2, 64, 4, 32), (8192, 0, 32, 1), None),            # broadcast time
    (0, (1, 64, 1, 32), (7, 32, 5, 1), [32, 32, 32]),       # size-1 dims
    (0, (2, 3, 4, 32), (2 ** 40, 128, 32, 1), None),        # stride past 2**40 B
])
def test_tma_stride_eligibility(ptr, shape, strides, want):
    assert fa.tma_strides(ptr, shape, strides) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_still_raise(dtype):
    q = torch.zeros((1, 8, 2, 32), dtype=dtype)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fa.check_qkv(q, q, q)


# (kernel, Dh): rows of a streamed tile, the widest whose accumulator and
# fragment floats a thread fit 160 (dQ Dh/2 + n, dK/dV Dh + n).
BWD_TILE = {("dq", 32): 128, ("dq", 64): 128, ("dq", 96): 64, ("dq", 128): 64,
            ("dkv", 32): 128, ("dkv", 64): 64, ("dkv", 96): 64,
            ("dkv", 128): 32}


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_bwd_plan_chunks_like_the_forward(kernel, dh):
    plan = fb.sm90_bwd_plan(dh, kernel)
    assert (plan.swizzle, plan.chunk_cols, plan.chunks) == CHUNKING[dh]
    assert plan.tile == BWD_TILE[(kernel, dh)]
    # two warpgroups of 64 rows, and no separate producer warp
    assert (plan.block, plan.threads) == (128, 2 * 128)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_bwd_plan_shared_memory_fits_a_block(kernel, dh):
    plan = fb.sm90_bwd_plan(dh, kernel)
    rows = 0 if kernel == "dq" else 2 * 4 * plan.tile     # fp32 L and D
    stage = 2 * 2 * plan.tile * dh + rows
    assert plan.smem_bytes == 1024 + 4 * 128 * dh + plan.stages * stage + 128
    assert plan.smem_bytes <= fa.SMEM_LIMIT == 232_448
    assert plan.stages == 4        # every head width takes the deepest ring
    # every tile starts on the 1024-byte period of the 128-byte swizzle
    assert (2 * dh * plan.block) % 1024 == 0
    assert (2 * dh * plan.tile) % 1024 == 0
    # the mbarriers: one for the block's rows, a full and an empty per stage
    assert 8 * (1 + 2 * plan.stages) <= 128
    assert plan.c_args() == [128, plan.tile, 256, plan.swizzle, plan.stages,
                             plan.smem_bytes]


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_bwd_plan_register_arithmetic(kernel, dh):
    """Accumulators (dQ: Dh/2 floats a thread; dK and dV: Dh) and the S and
    dP fragments (tile/2 each) stay within the budget of 160, which leaves
    95 of the 255 registers a thread may use for addresses and the packed
    fragments: the eight warps of a block put two on each of the SM's four
    sub-partitions of 16,384 registers (a ninth, producer warp would put
    three on one and cap a thread at 168). The widest tile that fits is
    taken."""
    plan = fb.sm90_bwd_plan(dh, kernel)
    acc = dh // 2 if kernel == "dq" else dh
    assert plan.fragments(plan.tile) == acc + plan.tile <= plan.frag_budget
    assert 16384 // (2 * 32) == 256 and plan.max_registers == 255
    assert 16384 // (3 * 32) // 8 * 8 == 168       # with a ninth warp
    assert plan.max_registers - plan.frag_budget == 95
    wider = {32: 64, 64: 128, 128: None}[plan.tile]
    assert wider is None or plan.fragments(wider) > plan.frag_budget


@pytest.mark.parametrize("dh,kernel", [(40, "dq"), (256, "dkv"), (64, "fwd")])
def test_bwd_plan_refuses_other_widths_and_kernels(dh, kernel):
    with pytest.raises(ValueError, match=f"head width {dh}|kernel 'fwd'"):
        fb.sm90_bwd_plan(dh, kernel)
