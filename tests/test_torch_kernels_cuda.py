"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA Hopper card and ``nvcc`` and skips without
a CUDA device. The file imports neither JAX nor the reference package, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import entropy_hist as eh
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import lowrank as lr
from repro_torch.kernels import pack as pk
from repro_torch.kernels import ref

DTYPES = ["float32", "bfloat16"]


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=10 * tol)


def _assert_orthonormal_span(got: np.ndarray, want: np.ndarray):
    r = got.shape[-1]
    np.testing.assert_allclose(got.T @ got, np.eye(r), atol=2e-4)
    np.testing.assert_allclose(np.abs(got.T @ want), np.eye(r), atol=2e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (Hopper) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ef_factor_kernel's tile is 128 rows x 64 ranks, k-tiles 32 deep for P's
# 16-byte path and 16 otherwise; fp32 rows take 16-byte loads at n % 4 ==
# 0, bf16 ones at n % 8 == 0. After the first four: m and n off the tiles
# (n % 32 == 8); n % 4 == 2; n % 4 == 0 but n % 8 == 4; K under one k-tile
# (n = 12 for P, m = 9 for Q); split groups whose last chunk is ragged (P:
# 18 chunks of 288 over n = 5000; Q: 11 of 288 over m = 3000); r = 2 and
# r = 128.
CUDA_STACKS = [(4, 192, 320, 64), (3, 100, 77, 5), (2, 130, 1030, 70),
               (1, 1920, 7680, 64),
               (2, 200, 328, 64), (2, 150, 98, 32), (2, 150, 140, 32),
               (2, 130, 12, 8), (2, 9, 200, 16), (1, 100, 5000, 64),
               (1, 3000, 100, 16), (2, 190, 260, 2), (2, 190, 260, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,n,r", CUDA_STACKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernels_match_plain(cuda_device, e, m, n, r, dtype):
    dt = getattr(torch, dtype)
    g = torch.from_numpy(_np((e, m, n), 14)).to(cuda_device, dt)
    err = torch.from_numpy(_np((e, m, n), 15)).to(cuda_device, dt)
    q = torch.from_numpy(_np((e, n, r), 16)).to(cuda_device)
    # fp32 sums of n (or m) terms in another order than cuBLAS
    p = lr.ef_lowrank_p(g, err, q)
    _close(p, ref.ef_lowrank_p(g, err, q), 1e-4 * max(1.0, (n / 128) ** 0.5))
    p_hat = torch.from_numpy(_np((e, m, r), 17)).to(cuda_device)
    qn = lr.ef_lowrank_q(g, err, p_hat)
    _close(qn, ref.ef_lowrank_q(g, err, p_hat), 1e-4 * max(1.0, (m / 128) ** 0.5))
    gh, ne = lr.decompress_residual(p_hat, q, g, err)
    ghr, ner = ref.decompress_residual(p_hat, q, g, err)
    tol = 1e-4 if dtype == "float32" else 1e-1
    _close(gh, ghr.to(dt), tol)
    _close(ne, ner.to(dt), tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_factor_kernels_bit_equal_across_calls(cuda_device, dtype):
    """P and Q at a shape both split (no atomics: partials summed in split
    order), and a scalar-path shape, give the same bits on every call."""
    for e, m, n, r in [(1, 3000, 5000, 64), (1, 3001, 4999, 40)]:
        dt = getattr(torch, dtype)
        g = torch.from_numpy(_np((e, m, n), 30)).to(cuda_device, dt)
        err = torch.from_numpy(_np((e, m, n), 31)).to(cuda_device, dt)
        q = torch.from_numpy(_np((e, n, r), 32)).to(cuda_device)
        p_hat = torch.from_numpy(_np((e, m, r), 33)).to(cuda_device)
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        for trans in (False, True):
            assert lr.factor_plan(e, m, n, r, dt, sms, trans=trans).splits > 1
        for fn, f in ((lr.ef_lowrank_p, q), (lr.ef_lowrank_q, p_hat)):
            assert torch.equal(fn(g, err, f), fn(g, err, f))


# gram_schmidt_kernel's plans (lowrank.gs_plan): the main path's three
# panels (shared-memory slabs), m not a multiple of the rows per block
# (1001, 1000), r = 1, a cluster with an empty block (m = 17), and the
# device-memory path: r = 128 at m = 7680 and the 4 MiB panel the GS
# routing admits.
GS_SHAPES = [(1, 64, 4), (8, 7680, 64), (3, 1000, 24), (32, 1920, 64),
             (8, 1920, 64), (3, 1001, 24), (2, 1920, 1), (2, 17, 3),
             (1, 7680, 128), (1, 16384, 64)]
GS_TOL = 1e-4    # relative to the plain version: sums in another order


def _gs_close(got, want):
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= GS_TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,r", GS_SHAPES)
def test_cuda_gram_schmidt_matches_plain(cuda_device, e, m, r):
    p = torch.from_numpy(_np((e, m, r), 18)).to(cuda_device)
    got = lr.gram_schmidt_panel(p)
    want = lr.plain_gram_schmidt(p)
    _gs_close(got, want)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    for i in range(e):
        _assert_orthonormal_span(got[i], want[i])


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,r", [(8, 1920, 64), (3, 1001, 24),
                                   (1, 16384, 64), (1, 7680, 128)])
def test_cuda_gram_schmidt_bit_equal_across_calls(cuda_device, e, m, r):
    """Both paths (shared-memory and device-memory slabs): the cluster's
    partial sums are taken in block order, so every call gives the same
    bits."""
    p = torch.from_numpy(_np((e, m, r), 34)).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    path = lr.gs_plan(e, m, r, sms).path
    assert path == ("device" if m * r >= 7680 * 128 else "shared")
    assert torch.equal(lr.gram_schmidt_panel(p), lr.gram_schmidt_panel(p))


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,r,zero", [(4, 1920, 16, 5), (2, 1001, 24, 0),
                                        (1, 7680, 128, 77)])
def test_cuda_gram_schmidt_zero_column(cuda_device, e, m, r, zero):
    """A zero column stays zero (v / (0 + eps)) and the later columns are
    orthonormalized past it: held to the plain version directly, since the
    columns are not orthonormal."""
    p = torch.from_numpy(_np((e, m, r), 35)).to(cuda_device)
    p[..., zero] = 0
    got = lr.gram_schmidt_panel(p)
    assert torch.count_nonzero(got[..., zero]) == 0
    _gs_close(got, lr.plain_gram_schmidt(p))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("path", [None, "device"])
def test_cuda_gram_schmidt_every_cluster_size(cuda_device, cluster, path):
    """Each cluster size the plan may take, forced, on the plan's path and
    on the device-memory one: at (2, 1920, 64) one or two blocks a panel
    need the device-memory slab, four or more fit shared memory."""
    p = torch.from_numpy(_np((2, 1920, 64), 36)).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = lr.gs_plan(2, 1920, 64, sms, cluster=cluster, path=path)
    assert plan.path == (path or ("device" if cluster < 4 else "shared"))
    got = lr._launch_gs(p, cluster=cluster, path=path)
    _gs_close(got, lr.plain_gram_schmidt(p))
    assert torch.equal(got, lr._launch_gs(p, cluster=cluster, path=path))


@pytest.mark.cuda
def test_cuda_wrappers_count_launches(cuda_device):
    before = [k.launches for k in lr.KERNELS]
    g = torch.from_numpy(_np((2, 64, 64), 19)).to(cuda_device)
    q = torch.from_numpy(_np((2, 64, 8), 20)).to(cuda_device)
    p = lr.gram_schmidt_panel(lr.ef_lowrank_p(g, g, q))
    lr.decompress_residual(p, lr.ef_lowrank_q(g, g, p), g, g)
    assert [k.launches - b for k, b in zip(lr.KERNELS, before)] == [1, 1, 1, 1]


# Sizes of the wire codec's payloads: the tied wte member of gpt2-2.5b
# (50257 x 1920), a ragged n, under 512 words, and a single code.
PACK_SIZES = [50257 * 1920, 512 * 8 + 3, 2047, 7, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", PACK_SIZES)
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_pack_unpack_match_plain(cuda_device, bits, n, offset):
    """Bit-exact against the plain versions, codes spanning the full range;
    offset 1 makes the code array unaligned (the kernels' scalar path)."""
    rng = np.random.default_rng(n + bits)
    full = torch.from_numpy(rng.integers(0, 1 << bits, n + offset)
                            .astype(np.int32)).to(cuda_device)
    full[offset] = (1 << bits) - 1
    codes = full[offset:]
    before = [k.launches for k in pk.KERNELS]
    words = pk.pack_words(codes, bits)
    back = pk.unpack_words(words, bits, n)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(pk.KERNELS, before)] == [1, 1]
    assert words.dtype == torch.uint32 and words.shape == (-(-n // (32 // bits)),)
    assert torch.equal(words.view(torch.int32),
                       ref.pack_bits(codes, bits).view(torch.int32))
    assert torch.equal(back, codes)
    assert torch.equal(back, ref.unpack_bits(words, bits, n))


def _rel_close(got, want, tol, what):
    """max|got - want| <= tol * max|want|, in fp32."""
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert diff <= tol * scale, f"{what}: {diff:.3e} > {tol:.0e} x {scale:.3e}"


# Kernel against plain version, relative to the plain output's largest
# magnitude: fp32 sums in another order than cuBLAS; bf16 outputs round once.
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("rep", [1, 7])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_kernels_match_plain(cuda_device, dh, rep, causal, dtype):
    """Forward, LSE, dQ and dK/dV at a ragged T (non-causal: Tq != Tk)."""
    dt = getattr(torch, dtype)
    hkv = 2 if rep == 1 else 1
    tq, tk = (200, 200) if causal else (130, 250)
    q, k, v, do = (torch.from_numpy(_np(shape, seed)).to(cuda_device, dt)
                   for shape, seed in (((2, tq, hkv * rep, dh), 40),
                                       ((2, tk, hkv, dh), 41),
                                       ((2, tk, hkv, dh), 42),
                                       ((2, tq, hkv * rep, dh), 43)))
    o, lse = fb._fwd_with_stats(q, k, v, causal=causal)
    p_o, p_lse = ref.flash_fwd(q, k, v, causal)
    delta = ref.flash_delta(o, do)
    dq = fb.flash_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fb.flash_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    _rel_close(o, p_o, tol, "o")
    _rel_close(fa.flash_attention(q, k, v, causal=causal),
               ref.flash_reference(q, k, v, causal), tol, "attention")
    _rel_close(lse, p_lse, 1e-5, "lse")
    _rel_close(dq, ref.flash_dq(q, k, v, do, lse, delta, causal), tol, "dq")
    p_dk, p_dv = ref.flash_dkv(q, k, v, do, lse, delta, causal)
    _rel_close(dk, p_dk, tol, "dk")
    _rel_close(dv, p_dv, tol, "dv")
    assert (dq.dtype, dk.dtype, dv.dtype) == (dt, dt, dt)


def _bf16_qkv(device, b, tq, tk, h, hkv, dh, layout="plain", seed=50):
    """bf16 q (b, tq, h, dh) and k, v (b, tk, hkv, dh). ``fused_3h`` and
    ``fused_h3`` take them as strided views of one projection, laid out
    (b, t, 3, h, dh) (time stride 3 h dh) or (b, t, h, 3, dh) (head stride
    3 dh); both need tq == tk and h == hkv."""
    if layout == "plain":
        return [torch.from_numpy(_np(shape, seed + i)).to(device, torch.bfloat16)
                for i, shape in enumerate(((b, tq, h, dh), (b, tk, hkv, dh),
                                           (b, tk, hkv, dh)))]
    assert tq == tk and h == hkv
    shape = (b, tq, 3, h, dh) if layout == "fused_3h" else (b, tq, h, 3, dh)
    qkv = torch.from_numpy(_np(shape, seed)).to(device, torch.bfloat16)
    return [qkv.select(2 if layout == "fused_3h" else 3, i) for i in range(3)]


def _check_bf16_fwd(q, k, v, causal):
    """o at 1e-2 and lse at 1e-5 (relative to the plain version's largest
    magnitude), through the tensor-core kernel only."""
    before = dict(fa.flash_fwd.launches_by_kernel)
    o, lse = fa.flash_fwd(q, k, v, causal=causal, with_lse=True)
    att = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.flash_fwd.launches_by_kernel.items()} \
        == {"flash_fwd_sm90": 2, "flash_fwd_fma": 0}
    p_o, p_lse = ref.flash_fwd(q, k, v, causal)
    _rel_close(o, p_o, FLASH_TOL["bfloat16"], "o")
    _rel_close(att, ref.flash_reference(q, k, v, causal), FLASH_TOL["bfloat16"],
               "attention")
    _rel_close(lse, p_lse, 1e-5, "lse")
    assert o.dtype == torch.bfloat16 and torch.isfinite(o.float()).all()


# T around the 64-row warpgroup halves and the 128-row tiles, and ragged
SM90_T = [1, 63, 64, 65, 127, 128, 129, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("t", SM90_T)
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("rep", [1, 7])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_fwd_sm90_matches_plain(cuda_device, t, dh, rep, causal):
    hkv = 2 if rep == 1 else 1
    _check_bf16_fwd(*_bf16_qkv(cuda_device, 2, t, t, hkv * rep, hkv, dh),
                    causal)


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk", [(65, 1000), (1000, 129), (1, 300), (300, 1)])
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_cuda_flash_fwd_sm90_cross_lengths(cuda_device, tq, tk, dh):
    """Tq != Tk, not causal (the reference's cross-attention case)."""
    _check_bf16_fwd(*_bf16_qkv(cuda_device, 2, tq, tk, 4, 2, dh), False)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["fused_3h", "fused_h3"])
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_fwd_sm90_reads_fused_projections(cuda_device, layout, dh,
                                                     causal):
    """q, k and v as strided views of one projection, read in place."""
    q, k, v = _bf16_qkv(cuda_device, 2, 200, 200, 3, 3, dh, layout)
    assert fa.tma_strides(q.data_ptr(), q.shape, q.stride()) is not None
    _check_bf16_fwd(q, k, v, causal)


def _bf16_do(device, q, layout="plain", seed=59):
    """A bf16 dO of q's shape: contiguous, a transposed (B, H, T, Dh)
    tensor seen as (B, T, H, Dh) (strided; TMA reads it in place), or
    every other column of a wider tensor (head dimension not contiguous:
    the wrapper copies it)."""
    b, t, h, dh = q.shape
    if layout == "transposed":
        return torch.from_numpy(_np((b, h, t, dh), seed)).to(
            device, torch.bfloat16).transpose(1, 2)
    if layout == "every_other":
        return torch.from_numpy(_np((b, t, h, 2 * dh), seed)).to(
            device, torch.bfloat16)[..., ::2]
    return torch.from_numpy(_np((b, t, h, dh), seed)).to(device, torch.bfloat16)


def _check_bf16_bwd(q, k, v, do, causal, vanish=()):
    """dQ, dK and dV at 1e-2 (relative to the plain version's largest
    magnitude), through the tensor-core kernels only, and bit-equal over
    two calls (no atomics). The gradients named in ``vanish`` are zero in
    exact arithmetic: they and their plain versions are held to
    ``VANISH_ATOL`` instead."""
    o, lse = fb._fwd_with_stats(q, k, v, causal=causal)
    delta = ref.flash_delta(o, do)
    before = {**fb.flash_dq.launches_by_kernel, **fb.flash_dkv.launches_by_kernel}
    runs = [(fb.flash_dq(q, k, v, do, lse, delta, causal=causal),
             *fb.flash_dkv(q, k, v, do, lse, delta, causal=causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    after = {**fb.flash_dq.launches_by_kernel, **fb.flash_dkv.launches_by_kernel}
    assert {n: c - before[n] for n, c in after.items()} == {
        "flash_dq_sm90": 2, "flash_dq_fma": 0, "flash_dkv_sm90": 2,
        "flash_dkv_fma": 0}
    (dq, dk, dv), again = runs
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    tol = FLASH_TOL["bfloat16"]
    p_dk, p_dv = ref.flash_dkv(q, k, v, do, lse, delta, causal)
    plain = {"dq": ref.flash_dq(q, k, v, do, lse, delta, causal), "dk": p_dk,
             "dv": p_dv}
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        if name in vanish:
            for what, x in ((name, got), (f"plain {name}", plain[name])):
                big = x.float().abs().max().item()
                assert big <= VANISH_ATOL, f"{what}: {big:.3e} > {VANISH_ATOL:.0e}"
        else:
            _rel_close(got, plain[name], tol, name)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


# ragged T, one tile (under the 64 rows of a warpgroup), and the tiles' edges
SM90_BWD_T = [50, 128, 200, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("t", SM90_BWD_T)
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("rep", [1, 2, 7])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_bwd_sm90_matches_plain(cuda_device, t, dh, rep, causal):
    q, k, v = _bf16_qkv(cuda_device, 2, t, t, 2 * rep, 2, dh)
    _check_bf16_bwd(q, k, v, _bf16_do(cuda_device, q), causal)


# (Tq, Tk, causal) with Tq != Tk. A row that sees one key has P = 1 and
# dS = 0, so a single key (Tk = 1), or a single causal row (Tq = 1), makes dQ
# and dK vanish identically and leaves the relative bar no scale: the
# one-row and two-key cases take the shapes nearest to those instead.
CROSS = [(65, 1000, True), (65, 1000, False), (1000, 129, True),
         (1000, 129, False), (1, 300, False), (2, 300, True), (300, 2, True),
         (300, 2, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,causal", CROSS)
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_cuda_flash_bwd_sm90_cross_lengths(cuda_device, tq, tk, causal, dh):
    """Tq != Tk; causal rows align at the top left, as the reference's
    mask does, so keys past Tq get no gradient."""
    q, k, v = _bf16_qkv(cuda_device, 2, tq, tk, 4, 2, dh)
    _check_bf16_bwd(q, k, v, _bf16_do(cuda_device, q), causal)


# A row that sees one key has P = 1 and dS = 0: at Tk = 1, and at the single
# row of a causal Tq = 1, dQ and dK vanish identically and the relative bar
# has no scale. They are held against zero: what is left is fp32 rounding
# in dP - D, far below the unit-normal inputs' gradients of order 1. dV
# keeps the relative bar.
VANISH_ATOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,causal", [(300, 1, False), (1, 300, True)])
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_cuda_flash_bwd_sm90_single_key_or_row(cuda_device, tq, tk, causal, dh):
    q, k, v = _bf16_qkv(cuda_device, 2, tq, tk, 4, 2, dh)
    _check_bf16_bwd(q, k, v, _bf16_do(cuda_device, q), causal,
                    vanish=("dq", "dk"))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["fused_3h", "fused_h3"])
@pytest.mark.parametrize("do_layout", ["transposed", "every_other"])
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_bwd_sm90_reads_strided_inputs(cuda_device, layout,
                                                  do_layout, dh, causal):
    """q, k and v as strided views of one projection and a non-contiguous
    dO, as autograd hands them over."""
    q, k, v = _bf16_qkv(cuda_device, 2, 200, 200, 3, 3, dh, layout)
    do = _bf16_do(cuda_device, q, do_layout)
    assert not do.is_contiguous()
    _check_bf16_bwd(q, k, v, do, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 14, 2, 64), (2, 300, 4, 4, 96),
                                   (1, 200, 6, 3, 128), (2, 130, 2, 1, 32)])
def test_cuda_flash_attention_train_bf16_matches_plain_gradients(cuda_device,
                                                                 shape):
    """The autograd gradients of flash_attention_train in bf16 (tensor-core
    forward and backward) against autograd through the plain version."""
    b, t, h, hkv, dh = shape
    q, k, v = _bf16_qkv(cuda_device, b, t, t, h, hkv, dh)
    do = _bf16_do(cuda_device, q)
    before = {**fb.flash_dq.launches_by_kernel, **fb.flash_dkv.launches_by_kernel}
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fb.flash_attention_train(*leaves, True).backward(do)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref.flash_reference(*plain, True).backward(do)
    after = {**fb.flash_dq.launches_by_kernel, **fb.flash_dkv.launches_by_kernel}
    assert {n: c - before[n] for n, c in after.items()} == {
        "flash_dq_sm90": 1, "flash_dq_fma": 0, "flash_dkv_sm90": 1,
        "flash_dkv_fma": 0}
    for got, want, name in zip(leaves, plain, ("dq", "dk", "dv")):
        assert got.grad.dtype == torch.bfloat16
        _rel_close(got.grad, want.grad, FLASH_TOL["bfloat16"], name)


@pytest.mark.cuda
def test_cuda_flash_cu_refuses_bf16_backward(cuda_device):
    """flash.cu's entry points take fp32 only: a bf16 dQ or dK/dV launch is
    refused (cudaErrorInvalidValue), so each dtype has one kernel."""
    import ctypes
    q = torch.zeros((1, 64, 2, 64), device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 64), device=cuda_device)
    lib = fa._lib()
    p = lambda x: ctypes.c_void_p(x.data_ptr())
    st = list(q.stride()[:3]) * 4
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dims = [1, 64, 64, 2, 2, 64, 1, 1]                # dtype 1: bf16
    assert lib.repro_flash_dq(*[p(q)] * 4, p(lse), p(lse), p(q), *dims, *st,
                              stream) == 1
    assert lib.repro_flash_dkv(*[p(q)] * 4, p(lse), p(lse), p(q), p(q), *dims,
                               *st, stream) == 1


@pytest.mark.cuda
def test_cuda_flash_fwd_launches_one_kernel_per_dtype(cuda_device):
    q = torch.from_numpy(_np((1, 64, 2, 64), 51)).to(cuda_device)
    before = dict(fa.flash_fwd.launches_by_kernel)
    fa.flash_attention(q, q, q)
    fa.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    fb.flash_attention_train(*(q.bfloat16().requires_grad_(True),) * 3)
    assert {n: c - before[n] for n, c in fa.flash_fwd.launches_by_kernel.items()} \
        == {"flash_fwd_sm90": 2, "flash_fwd_fma": 1}


@pytest.mark.cuda
def test_cuda_flash_attention_train_matches_plain_gradients(cuda_device):
    q, k, v, do = (torch.from_numpy(_np(shape, seed)).to(cuda_device)
                   for shape, seed in (((2, 300, 14, 64), 44),
                                       ((2, 300, 2, 64), 45),
                                       ((2, 300, 2, 64), 46),
                                       ((2, 300, 14, 64), 47)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fb.flash_attention_train(*leaves, True)
    o.backward(do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref.flash_reference(*plain, True).backward(do)
    for got, want in zip(leaves, plain):
        _rel_close(got.grad, want.grad, 1e-5, "grad")


# Self-attention of the benchmark's two cells: (B, T, H, Hkv, Dh, d_model,
# QKV bias, RoPE): gpt2-2.5b at 8 x 1024, qwen2.5-3b at 2 x 4096 (GQA 16/2).
CELL_ATTN = {"gpt2-2.5b": (8, 1024, 20, 20, 96, 1920, False, False),
             "qwen2.5-3b": (2, 4096, 16, 2, 128, 2048, True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELL_ATTN))
def test_cuda_attn_apply_flash_route_matches_blockwise(cuda_device, monkeypatch,
                                                       cell):
    """attn_apply's flash route (bf16, causal) against its blockwise route
    on the same card at a cell's attention shape: the output and the
    gradients of q, k, v and of the four projection weights, at the bf16
    bar. The flash run launches one kernel of each kind and counts one
    ``flash`` call."""
    from repro_torch.models import layers as L
    b, t, h, hkv, dh, d, bias, rope = CELL_ATTN[cell]
    gen = torch.Generator().manual_seed(60)
    p = {k: w[0].to(cuda_device) for k, w in L.attn_init(
        gen, 1, d, h, hkv, dh, torch.bfloat16, qkv_bias=bias).items()}
    x = torch.from_numpy(_np((b, t, d), 61)).to(cuda_device, torch.bfloat16)
    dout = torch.from_numpy(_np((b, t, d), 62)).to(cuda_device, torch.bfloat16)
    seen = {}

    def keep(fn):
        def run(q, k, v, *args, **kw):
            for name, z in zip("qkv", (q, k, v)):
                z.retain_grad()
                seen[name] = z
            return fn(q, k, v, *args, **kw)
        return run

    monkeypatch.setattr(L, "flash_attention_train", keep(L.flash_attention_train))
    monkeypatch.setattr(L, "blockwise_attention", keep(L.blockwise_attention))
    decide, got = L.attn_route, {}
    for route in ("blockwise", "flash"):
        monkeypatch.setattr(L, "attn_route", decide if route == "flash"
                            else lambda *a: "blockwise")
        leaves = {k: w.clone().requires_grad_(True) for k, w in p.items()}
        calls = dict(L.attn_apply.calls_by_route)
        before = {**fa.flash_fwd.launches_by_kernel,
                  **fb.flash_dq.launches_by_kernel,
                  **fb.flash_dkv.launches_by_kernel}
        out = L.attn_apply(leaves, x, num_heads=h, num_kv_heads=hkv, head_dim=dh,
                           causal=True, use_rope=rope, rope_theta=1e6)
        out.backward(dout)
        torch.cuda.synchronize()
        after = {**fa.flash_fwd.launches_by_kernel,
                 **fb.flash_dq.launches_by_kernel,
                 **fb.flash_dkv.launches_by_kernel}
        flash = route == "flash"
        assert {r: n - calls[r] for r, n in L.attn_apply.calls_by_route.items()} \
            == {"flash": int(flash), "blockwise": int(not flash)}
        assert {n: c - before[n] for n, c in after.items()} == {
            "flash_fwd_sm90": int(flash), "flash_fwd_fma": 0,
            "flash_dq_sm90": int(flash), "flash_dq_fma": 0,
            "flash_dkv_sm90": int(flash), "flash_dkv_fma": 0}
        got[route] = {"out": out.detach(),
                      **{f"d{n}": seen[n].grad for n in "qkv"},
                      **{f"d{n}": leaves[n].grad for n in ("wq", "wk", "wv", "wo")}}
    for name, want in got["blockwise"].items():
        assert got["flash"][name].dtype == want.dtype == torch.bfloat16
        _rel_close(got["flash"][name], want, FLASH_TOL["bfloat16"], name)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,batch,seq", [("gpt2", 8, 1024),
                                            ("qwen2.5-3b", 2, 4096)])
def test_cuda_train_step_takes_flash_route(cuda_device, arch, batch, seq):
    """One flat training step of a cell's configuration at depth 4 (bf16,
    each block recomputed in the backward): every attn_apply call takes the
    flash route, the forward kernel runs twice a layer (the forward and its
    recompute) and each backward kernel once a layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.compressor import NO_COMPRESSION
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model
    from repro_torch.optim import adam
    from repro_torch.train.step import TrainStepConfig, make_train_step
    layers = 4
    cfg = dataclasses.replace(get_config(arch, "full"), num_layers=layers)
    assert cfg.remat and cfg.dtype == "bfloat16"
    model = build_model(cfg)
    params = model.init(0, cuda_device)
    acfg = adam.AdamConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    ost = adam.init(params, acfg)
    state = {"params": params, "opt_m": ost.m, "opt_v": ost.v,
             "opt_step": ost.step, "comp": {}}
    step = make_train_step(model, TrainStepConfig(
        policy_plan=NO_COMPRESSION, remat=False, adam=acfg),
        psum_mean=lambda x: x)
    batch = {k: torch.as_tensor(v).long().to(cuda_device) for k, v in
             next(SyntheticLM(cfg.vocab_size, seq, batch, seed=0).batches()).items()}
    calls = dict(L.attn_apply.calls_by_route)
    before = {**fa.flash_fwd.launches_by_kernel, **fb.flash_dq.launches_by_kernel,
              **fb.flash_dkv.launches_by_kernel}
    state, mets = step(state, batch)
    torch.cuda.synchronize()
    after = {**fa.flash_fwd.launches_by_kernel, **fb.flash_dq.launches_by_kernel,
             **fb.flash_dkv.launches_by_kernel}
    assert {r: n - calls[r] for r, n in L.attn_apply.calls_by_route.items()} \
        == {"flash": 2 * layers, "blockwise": 0}
    assert {n: c - before[n] for n, c in after.items()} == {
        "flash_fwd_sm90": 2 * layers, "flash_fwd_fma": 0,
        "flash_dq_sm90": layers, "flash_dq_fma": 0,
        "flash_dkv_sm90": layers, "flash_dkv_fma": 0}
    assert torch.isfinite(mets["loss"]).item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1_000_003, 1), (4099, 0), (7, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_hist_counts_bit_exact(cuda_device, n, offset, dtype):
    """Ragged n, an unaligned start (offset), outliers and infinities."""
    full = torch.from_numpy(_np((n + offset,), 48)).to(cuda_device)
    full[offset] = 1e30
    full[-1] = -float("inf")
    x = full[offset:].to(getattr(torch, dtype))
    lo, inv_w = torch.tensor(-4.0, device=cuda_device), 32.0
    got = eh.hist_counts(x, lo, inv_w)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.hist_counts(x, lo, torch.tensor(inv_w)))
    assert got.sum().item() == n and got[-1] >= 1 and got[0] >= 1


@pytest.mark.cuda
def test_cuda_flash_and_hist_wrappers_count_launches(cuda_device):
    kernels = fa.KERNELS + fb.KERNELS + eh.KERNELS
    before = [w.launches for w in kernels]
    q = torch.from_numpy(_np((1, 64, 2, 32), 49)).to(cuda_device)
    leaves = [q.clone().requires_grad_(True) for _ in range(3)]
    fb.flash_attention_train(*leaves).sum().backward()
    fa.flash_attention(q, q, q)
    eh.hist_counts(q.reshape(-1), -4.0, 32.0)
    assert [w.launches - b for w, b in zip(kernels, before)] == [2, 1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("n_pods", [2, 3])
def test_cuda_pod_stacked_outer_sync_matches_plain(cuda_device, n_pods):
    """The outer sync over a pod-stacked tree (a 2-D leaf as (N, m, n), a
    stacked block leaf as (N, L, m, n), folded to (N L, m, n)) through the
    kernels against the plain path on the same card, raw wire (under a
    coded one a factor code may flip at a quantizer boundary): synced
    delta, EF and Q, two rounds (the second adds back the first's EF)."""
    from repro_torch import tree
    from repro_torch.core import make_plan
    from repro_torch.core.compressor import classify_leaves
    from repro_torch.core.entropy import GDSConfig
    from repro_torch.core.powersgd import LowRankState
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.optim.outer import make_outer_sync_step

    shapes = {"a": (192, 320), "b": (3, 256, 130), "c": (64,)}
    like = {k: torch.zeros(s) for k, s in shapes.items()}
    plan = make_plan("fixed", classify_leaves(like, 3), fixed_rank=16)
    assert sorted(p for p, _ in plan.ranks) == ["['a']", "['b']"]
    carrier = make_pod_mesh(n_pods, [cuda_device] * n_pods)
    states = {}
    for path, r in plan.ranks:
        shape = shapes[path[2]]
        q = torch.from_numpy(_np(shape[:-2] + (shape[-1], r), 3))
        states[path] = LowRankState(
            q=q[None].expand((n_pods,) + tuple(q.shape)).clone().to(cuda_device),
            err=torch.zeros((n_pods,) + shape, device=cuda_device))
    comp = {True: states, False: {k: LowRankState(v.q.clone(), v.err.clone())
                                  for k, v in states.items()}}
    for rnd in range(2):
        delta = {k: torch.from_numpy(_np((n_pods,) + s, 10 * rnd + i))
                 .to(cuda_device) * 1e-2 for i, (k, s) in enumerate(shapes.items())}
        out = {}
        for kernels in (True, False):
            step = make_outer_sync_step(carrier, plan, GDSConfig(),
                                        use_kernels=kernels)
            synced, comp[kernels], h = step(delta, comp[kernels])
            out[kernels] = (synced, float(h))
        for got, want in zip(tree.leaves(out[True][0]),
                             tree.leaves(out[False][0])):
            assert torch.equal(got[0], got[-1])
            _close(got, want, 1e-5)
        assert abs(out[True][1] - out[False][1]) < 1e-5
        for path in comp[True]:
            _close(comp[True][path].err, comp[False][path].err, 1e-5)
            got, want = comp[True][path].q, comp[False][path].q
            sign = torch.sign((got * want).sum(dim=-2, keepdim=True))
            _close(got * sign, want, 1e-4)
