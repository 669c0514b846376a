"""The port's flash attention against the reference's Pallas kernels.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` runs them) and through the
port's CPU path (the plain versions the CUDA kernels are held to on the
card, in ``test_torch_kernels_cuda.py``), at ``tests/test_kernels.py``'s
tolerances: forward fp32 rtol 2e-5 / atol 2e-4, bf16 3e-2 / 3e-1;
gradients 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_fa
from repro.kernels import flash_attention_bwd as ref_fb
from repro.kernels import ref as ref_oracle
from repro.models.layers import blockwise_attention as ref_blockwise

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.models.layers import blockwise_attention

# (B, Tq, Tk, H, Hkv, Dh, bq, bk): tests/test_kernels.py's FLASH_CASES, then
# gpt2-2.5b's head width (96, H = Hkv) and qwen2-0.5b's GQA (rep 7, Dh 64)
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, 64, 64),
    (1, 512, 512, 8, 8, 128, 128, 128),
    (2, 128, 384, 4, 1, 32, 64, 128),
    (1, 128, 128, 4, 4, 96, 64, 64),
    (1, 128, 128, 7, 1, 64, 64, 64),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


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
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=10 * tol)


def _qkv(case, dtype, seeds=(31, 32, 33)):
    B, Tq, Tk, H, Hkv, Dh = case[:6]
    return [_pair(_np(s, seed), dtype) for s, seed in
            zip(((B, Tq, H, Dh), (B, Tk, Hkv, Dh), (B, Tk, Hkv, Dh)), seeds)]


def _heads_last(x, B, T, H, Dh):
    """The reference's (B*H, T, ...) kernel layout as (B, T, H, ...)."""
    return np.asarray(jnp.asarray(x, jnp.float32)).reshape(B, H, T, Dh) \
        .transpose(0, 2, 1, 3)


@pytest.fixture(scope="module")
def ref_stats():
    """The reference's ``_fwd_with_stats`` (o, lse) per (case, causal),
    computed once for the forward and backward tests below."""
    cache = {}

    def get(case, causal):
        if (case, causal) not in cache:
            (qj, _), (kj, _), (vj, _) = _qkv(case, "float32")
            cache[case, causal] = ref_fb._fwd_with_stats(
                qj, kj, vj, causal=causal, bq=case[6], bk=case[7],
                interpret=True)
        return cache[case, causal]
    return get


def _cases_and_masks():
    out = []
    for case in FLASH_CASES:
        for causal in (True, False):
            if causal and case[1] != case[2]:
                continue   # the reference's kernels need aligned positions
            out.append(pytest.param(case, causal,
                                    id=f"{'x'.join(map(str, case[:6]))}-"
                                       f"{'causal' if causal else 'full'}"))
    return out


@pytest.mark.parametrize("case,causal", _cases_and_masks())
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference_kernel(case, causal, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, dtype)
    want = ref_fa.flash_attention(qj, kj, vj, causal=causal, bq=case[6],
                                  bk=case[7])
    got = fa.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, TOL[dtype])
    _close(got, ref_oracle.flash_reference(qj, kj, vj, causal=causal),
           TOL[dtype])


@pytest.mark.parametrize("case,causal", _cases_and_masks())
def test_fwd_with_stats_matches_reference(ref_stats, case, causal):
    B, Tq, _, H, _, Dh = case[:6]
    (_, qt), (_, kt), (_, vt) = _qkv(case, "float32")
    o_ref, lse_ref = ref_stats(case, causal)
    o, lse = fb._fwd_with_stats(qt, kt, vt, causal=causal)
    assert lse.shape == (B, H, Tq) and lse.dtype == torch.float32
    _close(o, _heads_last(o_ref, B, Tq, H, Dh), TOL["float32"])
    _close(lse.reshape(B * H, Tq), lse_ref, TOL["float32"])


@pytest.mark.parametrize("case,causal", _cases_and_masks())
def test_bwd_matches_reference_on_the_same_inputs(ref_stats, case, causal):
    """The same (q, k, v, o, lse, dO) into both backward passes."""
    B, Tq, _, H, _, Dh = case[:6]
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, "float32")
    doj, dot = _pair(_np((B, Tq, H, Dh), 34), "float32")
    o_flat, lse_flat = ref_stats(case, causal)
    o = _heads_last(o_flat, B, Tq, H, Dh)
    want = ref_fb._bwd(qj, kj, vj, jnp.asarray(o), lse_flat, doj,
                       causal=causal, bq=case[6], bk=case[7], interpret=True)
    got = fb._bwd(qt, kt, vt, torch.from_numpy(np.ascontiguousarray(o)),
                  torch.from_numpy(np.array(lse_flat)).reshape(B, H, Tq),
                  dot, causal=causal)
    for g, w, t in zip(got, want, (qt, kt, vt)):
        assert g.shape == t.shape and g.dtype == t.dtype
        _close(g, w, TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 4, 2, 32), (1, 256, 8, 8, 64)])
def test_flash_attention_train_grads_match_reference(causal, shape):
    """Gradients of sum(sin(o)) through the autograd Function against
    jax.grad of the reference's custom_vjp (tests/test_kernels.py:239)."""
    B, T, H, Hkv, D = shape
    (qj, qt), (kj, kt), (vj, vt) = _qkv((B, T, T, H, Hkv, D), "float32",
                                        seeds=(41, 42, 43))

    def loss_ref(q, k, v):
        return jnp.sum(jnp.sin(ref_fb.flash_attention_train(q, k, v, causal,
                                                            64, 64)))

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(qj, kj, vj)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    o = fb.flash_attention_train(*leaves, causal)
    torch.sin(o).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(_f32(leaf.grad), _f32(w), rtol=1e-4,
                                   atol=1e-4)


def test_flash_matches_model_blockwise():
    """The port's flash attention and the port's model attention agree,
    as the reference's do (tests/test_kernels.py:226)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv((2, 256, 256, 4, 2, 64), "float32",
                                        seeds=(34, 35, 36))
    got = fa.flash_attention(qt, kt, vt, causal=True)
    _close(got, blockwise_attention(qt, kt, vt, causal=True, block_q=64),
           TOL["float32"])
    _close(got, ref_blockwise(qj, kj, vj, causal=True, block_q=64),
           TOL["float32"])


def test_kernel_entry_points_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="head width 48"):
        fa.check_qkv(q, q, q)
    q = torch.zeros(1, 8, 3, 32)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.check_qkv(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fa.check_qkv(q.half(), q.half(), q.half())
