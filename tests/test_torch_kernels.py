"""The port's PowerSGD kernels: plain versions against the reference's
oracles (``repro.kernels.ref``) and Pallas kernels (interpret mode), at
``tests/test_kernels.py``'s tolerances. The CUDA kernels are held against
their plain versions on the card in ``test_torch_kernels_cuda.py``."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lowrank as ref_lr
from repro.kernels import ref as ref_oracle

from repro_torch.kernels import entropy_hist as eh
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import lowrank as lr
from repro_torch.kernels import ops
from repro_torch.kernels import ref

STACKS = [(1, 128, 256), (2, 256, 128), (3, 128, 384)]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=10 * tol)


@pytest.mark.parametrize("shape", STACKS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rank", [4, 16])
def test_p_plain_matches_reference(shape, dtype, rank):
    e, m, n = shape
    gj, gt = _pair(_np(shape, 0), dtype)
    ej, et = _pair(_np(shape, 1), dtype)
    qj, qt = _pair(_np((e, n, rank), 2), "float32")
    got = lr.ef_lowrank_p(gt, et, qt)
    assert got.dtype == torch.float32 and got.shape == (e, m, rank)
    _close(got, ref_lr.ef_lowrank_p_batched(gj, ej, qj, interpret=True), TOL[dtype])
    for i in range(e):
        _close(got[i], ref_oracle.ef_lowrank_p(gj[i], ej[i], qj[i]), TOL[dtype])
    _close(ops.lowrank_p(gt[0], et[0], qt[0]),
           ref_lr.ef_lowrank_p(gj[0], ej[0], qj[0], interpret=True), TOL[dtype])


@pytest.mark.parametrize("shape", STACKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_q_plain_matches_reference(shape, dtype):
    e, m, n = shape
    gj, gt = _pair(_np(shape, 3), dtype)
    ej, et = _pair(_np(shape, 4), dtype)
    pj, pt = _pair(_np((e, m, 16), 5), "float32")
    got = lr.ef_lowrank_q(gt, et, pt)
    assert got.shape == (e, n, 16)
    _close(got, ref_lr.ef_lowrank_q_batched(gj, ej, pj, interpret=True), TOL[dtype])
    for i in range(e):
        _close(got[i], ref_oracle.ef_lowrank_q(gj[i], ej[i], pj[i]), TOL[dtype])
    _close(ops.lowrank_q(gt[0], et[0], pt[0]),
           ref_lr.ef_lowrank_q(gj[0], ej[0], pj[0], interpret=True), TOL[dtype])


@pytest.mark.parametrize("shape", STACKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decompress_plain_matches_reference(shape, dtype):
    e, m, n = shape
    tol = 1e-4 if dtype == "float32" else 1e-1
    gj, gt = _pair(_np(shape, 6), dtype)
    ej, et = _pair(_np(shape, 7), dtype)
    pj, pt = _pair(_np((e, m, 8), 8), "float32")
    qj, qt = _pair(_np((e, n, 8), 9), "float32")
    gh, ne = lr.decompress_residual(pt, qt, gt, et)
    assert gh.dtype == ne.dtype == gt.dtype
    ghr, ner = ref_lr.decompress_residual_batched(pj, qj, gj, ej, interpret=True)
    _close(gh, ghr, tol)
    _close(ne, ner, tol)
    for i in range(e):
        gho, neo = ref_oracle.decompress_residual(pj[i], qj[i], gj[i], ej[i])
        _close(gh[i], gho, tol)
        _close(ne[i], neo, tol)
    gh2, ne2 = ops.decompress_residual(pt[0], qt[0], gt[0], et[0])
    _close(gh2, gh[0], 0)
    _close(ne2, ne[0], 0)


def _assert_orthonormal_span(got: np.ndarray, want: np.ndarray):
    r = got.shape[-1]
    np.testing.assert_allclose(got.T @ got, np.eye(r), atol=2e-4)
    np.testing.assert_allclose(np.abs(got.T @ want), np.eye(r), atol=2e-3)


@pytest.mark.parametrize("e,m", [(1, 64), (2, 256), (3, 1024)])
@pytest.mark.parametrize("r", [4, 16, 64])
def test_gram_schmidt_plain_matches_reference(e, m, r):
    pj, pt = _pair(_np((e, m, r), 10), "float32")
    got = lr.gram_schmidt_panel(pt).numpy()
    pallas = np.asarray(ref_lr.gram_schmidt_panel_batched(pj, interpret=True))
    for i in range(e):
        _assert_orthonormal_span(got[i], np.asarray(ref_oracle.gram_schmidt(pj[i])))
        _assert_orthonormal_span(got[i], pallas[i])
        # the port's own modified-GS oracle spans the same columns too
        _assert_orthonormal_span(ref.gram_schmidt(pt[i]).numpy(), got[i])


def test_orthonormalize_routes_like_reference():
    """Gram-Schmidt panels under 4 MiB with m % 8 == 0, QR otherwise."""
    assert not ops._use_qr(7680, 64) and not ops._use_qr(1920, 64)
    assert ops._use_qr(100, 8)                  # m % 8
    assert ops._use_qr(20000, 64)               # 5 MB panel
    p = torch.from_numpy(_np((2, 100, 8), 11))
    q = ops.orthonormalize3(p)
    np.testing.assert_allclose(q.numpy(), torch.linalg.qr(p)[0].numpy())


def test_plain_path_counts_no_launches():
    before = [k.launches for k in lr.KERNELS]
    g = torch.from_numpy(_np((2, 64, 64), 12))
    q = torch.from_numpy(_np((2, 64, 8), 13))
    p = lr.ef_lowrank_p(g, g, q)
    lr.ef_lowrank_q(g, g, lr.gram_schmidt_panel(p))
    lr.decompress_residual(p, q, g, g)
    assert [k.launches for k in lr.KERNELS] == before


# ------------------------------------------- the launch layer, without a card
class _FakeEntryPoint:
    """Stands in for one C entry point: checks each call against the
    ``argtypes`` the wrapper module declared, records it, returns ``rc``."""

    def __init__(self, name, calls, rc):
        self.name, self.calls, self.rc = name, calls, rc
        self.argtypes = self.restype = None

    def __call__(self, *args):
        assert len(args) == len(self.argtypes), (self.name, len(args))
        for a, t in zip(args, self.argtypes):
            want = {ctypes.c_void_p: ctypes.c_void_p, ctypes.c_int: int,
                    ctypes.c_longlong: int, ctypes.c_float: float}[t]
            assert isinstance(a, want), (self.name, a, t)
        self.calls.append((self.name, args))
        return self.rc


def _fake_gs_occupancy(shared, cluster, rows, r, out):
    """A card of 132 SMs on which one block fits per SM: 132 // cluster
    clusters resident; the shared memory and column stride ``gs_smem``
    and ``gs_ld`` state."""
    res = ctypes.cast(out, ctypes.POINTER(ctypes.c_int))
    res[0] = 132 // cluster
    res[1] = lr.gs_smem(bool(shared), rows, r, cluster)
    res[2] = lr.gs_ld(rows)
    return 0


class _FakeLib:
    def __init__(self, card):
        self._card = card

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        fn = _FakeEntryPoint(name, self._card.calls, self._card.rc)
        if name == "repro_cuda_error_string":
            fn = lambda code: b"fake error"
        if name == "repro_gs_occupancy":
            fn = _fake_gs_occupancy
        setattr(self, name, fn)
        return fn


class _FakeCard:
    """One fake library per CUDA source, as ``build.load`` gives one per
    source, all recording into ``calls`` and returning ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc, self.libs = [], rc, {}

    def load(self, name):
        return self.libs.setdefault(name, _FakeLib(self))


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, with a recording library."""
    import contextlib
    import types
    card = _FakeCard()
    monkeypatch.setattr(lr.build, "load", card.load)
    for module in (lr, fa, fb, eh):
        monkeypatch.setattr(module, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    return card


def test_launches_match_the_declared_c_signatures(fake_card):
    g = torch.from_numpy(_np((1, 64, 7680), 21))
    q = torch.from_numpy(_np((1, 7680, 8), 22))
    before = [k.launches for k in lr.KERNELS]
    p = lr.ef_lowrank_p(g, g.to(torch.bfloat16).float(), q)
    lr.ef_lowrank_q(g.to(torch.bfloat16), g.to(torch.bfloat16), p)
    lr.decompress_residual(p, q, g, g)
    lr.gram_schmidt_panel(p)
    assert [k.launches - b for k, b in zip(lr.KERNELS, before)] == [1, 1, 1, 1]
    names = [name for name, _ in fake_card.calls]
    assert names == ["repro_lowrank_p", "repro_lowrank_q",
                     "repro_decompress_residual", "repro_gram_schmidt"]
    (_, p_args), (_, q_args), (_, d_args), (_, gs_args) = fake_card.calls
    # (E, m, n, r, splits, dtype); one block of 128 rows splits n into 30
    # chunks of 256 (MIN_CHUNK), short of the 264 resident blocks
    assert p_args[5:11] == (1, 64, 7680, 8, 30, 0)
    assert p_args[0].value == g.data_ptr() and p_args[3].value == p.data_ptr()
    assert p_args[4].value != p_args[3].value     # split partials
    assert q_args[5:11] == (1, 64, 7680, 8, 1, 1)  # bf16; m too short to split
    assert q_args[4].value == q_args[3].value
    assert d_args[6:11] == (1, 64, 7680, 8, 0)
    # (E, m, r, cluster, rows per block, shared slab, eps): a 64 x 8 panel
    # spread over 8 blocks of 8 rows, its slab in shared memory, no
    # device-memory scratch
    assert gs_args[3:10] == (1, 64, 8, 8, 8, 1, 1e-8)
    assert gs_args[0].value == p.data_ptr() and gs_args[2].value is None
    assert all(args[-1].value == 1234 for _, args in fake_card.calls)


def test_refused_launch_raises_and_counts_nothing(fake_card):
    fake_card.rc = 1
    g = torch.from_numpy(_np((2, 64, 64), 23))
    before = lr.gram_schmidt_panel.launches
    with pytest.raises(RuntimeError, match="fake error"):
        lr.gram_schmidt_panel(g[..., :8])
    assert lr.gram_schmidt_panel.launches == before
    with pytest.raises(TypeError, match="fp32 or bf16"):
        lr.ef_lowrank_p(g.double(), g.double(), g[..., :8].transpose(1, 2))


@pytest.mark.parametrize("case", ["float64", "int_r", "stack_of_70000",
                                  "mismatched_factor"])
def test_refused_factor_launch_raises_before_launch(fake_card, case):
    """What ef_factor_kernel does not take raises before anything launches:
    no call reaches the library and no launch is counted."""
    g = torch.from_numpy(_np((2, 64, 64), 25))
    q = torch.from_numpy(_np((2, 64, 8), 26))
    args, exc = {
        "float64": ((g.double(), g.double(), q), TypeError),
        "int_r": ((g.to(torch.int32), g.to(torch.int32), q), TypeError),
        # the grid's third axis holds E x splits <= 65535
        "stack_of_70000": ((torch.zeros(70000, 4, 4), torch.zeros(70000, 4, 4),
                            torch.zeros(70000, 4, 2)), ValueError),
        "mismatched_factor": ((g, g, q[:, :32]), ValueError),
    }[case]
    before = [k.launches for k in lr.KERNELS]
    for fn in (lr.ef_lowrank_p, lr.ef_lowrank_q):
        with pytest.raises(exc):
            fn(*args)
    assert fake_card.calls == []
    assert [k.launches for k in lr.KERNELS] == before


def test_factor_launch_passes_the_plans_splits(fake_card):
    """The wrappers hand the C entry points the splits of ``factor_plan``
    for the main path's three fp32 shape groups, on CPU tensors of those
    sizes that are never written (the plan reads shapes and addresses)."""
    calls = []
    for e, m, n, r in [(32, 1920, 1920, 64), (8, 1920, 7680, 64),
                       (8, 7680, 1920, 64)]:
        g = torch.empty((e, m, n))
        f_p, f_q = torch.empty((e, n, r)), torch.empty((e, m, r))
        lr.ef_lowrank_p(g, g, f_p)
        lr.ef_lowrank_q(g, g, f_q)
        for trans, f in ((False, f_p), (True, f_q)):
            calls.append(lr.factor_plan(e, m, n, r, g.dtype, 132, trans=trans,
                                        ptrs=(g.data_ptr(),) * 2
                                        + (f.data_ptr(),)).splits)
    assert [args[9] for _, args in fake_card.calls] == calls == [1, 1, 2, 1,
                                                                 1, 2]


@pytest.mark.parametrize("shape", [(32, 1920, 64), (8, 1920, 64),
                                   (8, 7680, 64), (3, 1001, 24),
                                   (1, 7680, 128), (1, 16384, 64)])
def test_gs_launch_passes_the_plan(fake_card, shape):
    """The wrapper hands ``repro_gram_schmidt`` what ``gs_plan`` decides
    (cluster, rows per block, path), and a device-memory slab, (E C, r,
    ld), only on the device path; the 2-D form goes through the same
    plan."""
    e, m, r = shape
    p = torch.zeros(shape)
    before = lr.gram_schmidt_panel.launches
    lr.gram_schmidt_panel(p)
    plan = lr.gs_plan(e, m, r, 132, active=lambda c, path, rows: 132 // c)
    (name, args), = fake_card.calls
    assert name == "repro_gram_schmidt"
    assert args[3:9] == (e, m, r, plan.cluster, plan.rows,
                         int(plan.path == "shared"))
    assert (args[2].value is None) == (plan.path == "shared")
    assert lr.gram_schmidt_panel.launches == before + 1
    if e == 1 and not ops._use_qr(m, r):
        ops.orthonormalize(p[0])
        assert fake_card.calls[1][1][3:9] == args[3:9]


def _bwd_by_kernel(before=None) -> dict:
    """The backward wrappers' launches by kernel, less ``before``."""
    now = {**fb.flash_dq.launches_by_kernel, **fb.flash_dkv.launches_by_kernel}
    return now if before is None else {n: c - before[n] for n, c in now.items()}


def test_flash_and_hist_launches_match_the_declared_c_signatures(fake_card):
    """The flash entry points read q, k and v in place through their
    strides: here slices of one fused (B, T, H + 2, Dh) projection."""
    qkv = torch.from_numpy(_np((2, 70, 9, 96), 24))
    q, k, v = qkv[:, :, :7], qkv[:, :, 7:8], qkv[:, :, 8:]
    kernels = fa.KERNELS + fb.KERNELS + eh.KERNELS
    before = [w.launches for w in kernels]
    by_kernel = _bwd_by_kernel()
    o, lse = fa.flash_fwd(q, k, v, causal=True, with_lse=True)
    fa.flash_attention(q, k, v, causal=False)
    fb.flash_dq(q, k, v, q, lse, lse, causal=True)
    fb.flash_dkv(q, k, v, q, lse, lse, causal=False)
    eh.hist_counts(qkv.reshape(-1), -1.0, 2.0, num_bins=64)
    assert [w.launches - b for w, b in zip(kernels, before)] == [2, 1, 1, 1]
    # fp32 gradients run flash.cu's FMA kernels
    assert _bwd_by_kernel(by_kernel) == {"flash_dq_sm90": 0, "flash_dq_fma": 1,
                                         "flash_dkv_sm90": 0,
                                         "flash_dkv_fma": 1}
    assert [name for name, _ in fake_card.calls] == [
        "repro_flash_fwd", "repro_flash_fwd", "repro_flash_dq",
        "repro_flash_dkv", "repro_hist_counts"]
    (_, f1), (_, f2), (_, dq), (_, dkv), (_, h) = fake_card.calls
    dims = (2, 70, 70, 7, 1, 96)
    views = [t.stride()[:3] for t in (q, k, v)]
    assert f1[5:13] == dims + (1, 0) and f2[5:13] == dims + (0, 0)
    assert f1[13:22] == sum(views, ()) and f2[13:22] == f1[13:22]
    assert [a.value for a in f1[:3]] == [t.data_ptr() for t in (q, k, v)]
    assert f1[3].value == o.data_ptr() and f1[4].value == lse.data_ptr()
    assert f2[4].value is None                     # no LSE rows asked for
    assert dq[7:15] == dims + (1, 0) and dkv[8:16] == dims + (0, 0)
    assert dq[15:27] == sum(views, ()) + q.stride()[:3]
    assert dkv[16:28] == dq[15:27]
    assert h[1:2] == (qkv.numel(),) and h[4:6] == (64, 0)
    assert all(args[-1].value == 1234 for _, args in fake_card.calls)


def test_refused_flash_and_hist_launches_raise_and_count_nothing(fake_card):
    fake_card.rc = 1
    q = torch.from_numpy(_np((1, 16, 2, 32), 26))
    before = [w.launches for w in fa.KERNELS + eh.KERNELS]
    with pytest.raises(RuntimeError, match="repro_flash_fwd.*fake error"):
        fa.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="repro_hist_counts.*fake error"):
        eh.hist_counts(q.reshape(-1), 0.0, 1.0)
    assert [w.launches for w in fa.KERNELS + eh.KERNELS] == before
    with pytest.raises(ValueError, match="num_bins=2048"):
        eh.hist_counts(q.reshape(-1), 0.0, 1.0, num_bins=2048)
    with pytest.raises(ValueError, match="head width 40"):
        fa.flash_attention(q[..., :20].repeat(1, 1, 1, 2)[..., :40],
                           q[..., :20].repeat(1, 1, 1, 2)[..., :40],
                           q[..., :20].repeat(1, 1, 1, 2)[..., :40])


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_bf16_flash_fwd_launches_the_tensor_core_kernel(fake_card, dh):
    """bf16 q/k/v go to ``repro_flash_fwd_sm90`` with their TMA strides and
    the plan, read in place as slices of a fused (B, T, 3, H, Dh)
    projection; fp32 ones to ``repro_flash_fwd``; counted per kernel."""
    qkv = torch.from_numpy(_np((2, 70, 3, 4, dh), 27)).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1, :2], qkv[:, :, 2, :2]
    by_kernel = dict(fa.flash_fwd.launches_by_kernel)
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, causal=True, with_lse=True)
    fa.flash_fwd(q.float(), k.float(), v.float(), causal=False)
    assert fa.flash_fwd.launches - before == 2
    assert {n: c - by_kernel[n] for n, c in
            fa.flash_fwd.launches_by_kernel.items()} == {
        "flash_fwd_sm90": 1, "flash_fwd_fma": 1}
    (n1, a1), (n2, a2) = fake_card.calls
    assert (n1, n2) == ("repro_flash_fwd_sm90", "repro_flash_fwd")
    assert [a.value for a in a1[:3]] == [t.data_ptr() for t in (q, k, v)]
    assert a1[3].value == o.data_ptr() and a1[4].value == lse.data_ptr()
    assert a1[5:12] == (2, 70, 70, 4, 2, dh, 1)
    assert a1[12:21] == sum((t.stride()[:3] for t in (q, k, v)), ())
    assert list(a1[21:27]) == fa.sm90_plan(dh).c_args()
    assert a2[12] == 0                                # fp32 dtype code


def test_bf16_flash_fwd_copies_what_tma_cannot_read(fake_card):
    """A base off 16 bytes and a head stride off 16 bytes are copied to a
    contiguous tensor before the launch; an aligned tensor is not."""
    base = torch.from_numpy(_np((1, 40, 2, 2 * 32 + 8), 28)).to(torch.bfloat16)
    shifted = base.reshape(-1)[1:1 + 40 * 2 * 32].view(1, 40, 2, 32)
    odd_heads = base[..., 4:36]                       # head stride 72 elements
    good = base[..., :32].contiguous()
    fa.flash_fwd(shifted, odd_heads, good, causal=False)
    (_, args), = fake_card.calls
    assert args[0].value != shifted.data_ptr() and args[0].value % 16 == 0
    assert args[1].value != odd_heads.data_ptr()
    assert args[2].value == good.data_ptr()
    assert args[12:21] == (32, 64, 32) * 3          # B = 1: batch stride Dh


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("hkv", [4, 2])
def test_bf16_flash_bwd_launches_the_tensor_core_kernels(fake_card, dh, hkv):
    """bf16 dQ and dK/dV go to ``repro_flash_dq_sm90`` and
    ``repro_flash_dkv_sm90`` with the TMA strides of q, k, v (slices of a
    fused (B, T, 3, H, Dh) projection) and of a dO that is a transposed
    view, and each kernel's plan; fp32 ones to ``flash.cu``'s; counted
    per kernel. Under GQA (hkv 2 of 4 heads) the dK/dV kernel writes fp32
    partials per query head, which the wrapper sums to bf16."""
    qkv = torch.from_numpy(_np((2, 70, 3, 4, dh), 29)).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1, :hkv], qkv[:, :, 2, :hkv]
    do = torch.from_numpy(_np((2, 4, 70, dh), 30)).to(torch.bfloat16)
    do = do.transpose(1, 2)                           # (B, T, H, Dh) view
    lse = torch.from_numpy(_np((2, 4, 70), 31))
    by_kernel = _bwd_by_kernel()
    dq = fb.flash_dq(q, k, v, do, lse, lse, causal=True)
    dk, dv = fb.flash_dkv(q, k, v, do, lse, lse, causal=False)
    fb.flash_dq(q.float(), k.float(), v.float(), do.float(), lse, lse)
    fb.flash_dkv(q.float(), k.float(), v.float(), do.float(), lse, lse)
    assert _bwd_by_kernel(by_kernel) == {"flash_dq_sm90": 1, "flash_dq_fma": 1,
                                         "flash_dkv_sm90": 1,
                                         "flash_dkv_fma": 1}
    names = [name for name, _ in fake_card.calls]
    assert names == ["repro_flash_dq_sm90", "repro_flash_dkv_sm90",
                     "repro_flash_dq", "repro_flash_dkv"]
    (_, a_dq), (_, a_dkv), (_, f_dq), (_, f_dkv) = fake_card.calls
    inputs = [t.data_ptr() for t in (q, k, v, do)] + [lse.data_ptr()] * 2
    views = sum((t.stride()[:3] for t in (q, k, v, do)), ())
    assert do.stride()[:3] == (70 * 4 * dh, dh, 70 * dh)   # read in place
    assert [a.value for a in a_dq[:6]] == inputs
    assert a_dq[6].value == dq.data_ptr()
    assert a_dq[7:14] == (2, 70, 70, 4, hkv, dh, 1)
    assert a_dq[14:26] == views
    assert list(a_dq[26:32]) == fb.sm90_bwd_plan(dh, "dq").c_args()
    assert [a.value for a in a_dkv[:6]] == inputs
    assert a_dkv[8:15] == (2, 70, 70, 4, hkv, dh, 0)
    assert a_dkv[15:27] == views
    assert list(a_dkv[27:33]) == fb.sm90_bwd_plan(dh, "dkv").c_args()
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    if hkv == 4:      # bf16 written by the kernel itself
        assert (a_dkv[6].value, a_dkv[7].value) == (dk.data_ptr(), dv.data_ptr())
    else:             # fp32 partials, summed over each kv head's group
        assert dk.data_ptr() not in (a_dkv[6].value, a_dkv[7].value)
    assert f_dq[14] == 0 and f_dkv[15] == 0          # fp32 dtype code
    assert all(args[-1].value == 1234 for _, args in fake_card.calls)


def test_refused_bf16_flash_bwd_launches_raise_and_count_nothing(fake_card):
    fake_card.rc = 1
    q = torch.from_numpy(_np((1, 16, 2, 64), 32)).to(torch.bfloat16)
    lse = torch.from_numpy(_np((1, 2, 16), 33))
    before = [w.launches for w in fb.KERNELS], _bwd_by_kernel()
    with pytest.raises(RuntimeError, match="repro_flash_dq_sm90.*fake error"):
        fb.flash_dq(q, q, q, q, lse, lse)
    with pytest.raises(RuntimeError, match="repro_flash_dkv_sm90.*fake error"):
        fb.flash_dkv(q, q, q, q, lse, lse)
    assert ([w.launches for w in fb.KERNELS], _bwd_by_kernel()) == before


def test_build_target_follows_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and the local headers it
    includes, so editing a shared header rebuilds every source that
    includes it, and no other."""
    from repro_torch.kernels import build
    (tmp_path / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <stdint.h>\nint b;\n")
    (tmp_path / "common.cuh").write_text('#pragma once\n#include "deep.cuh"\n')
    (tmp_path / "deep.cuh").write_text("int x = 1;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build._included(tmp_path / "a.cu", [])] == [
        "a.cu", "common.cuh", "deep.cuh"]
    a, b = build._target("a"), build._target("b")
    (tmp_path / "deep.cuh").write_text("int x = 2;\n")
    assert build._target("a") != a and build._target("b") == b
    assert build._target("a").name.startswith("liba-")
    real = [p.name for p in build._included(
        build.Path(fb.__file__).with_name("csrc") / "flash_bwd_sm90.cu", [])]
    assert real == ["flash_bwd_sm90.cu", "sm90_common.cuh"]
