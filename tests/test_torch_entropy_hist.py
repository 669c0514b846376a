"""The port's histogram kernel path and entropy probe against the reference.

The same numpy samples go through the JAX functions (the Pallas
``hist_counts`` in interpret mode, as ``tests/test_kernels.py`` runs it)
and through the port's CPU path, the plain version the CUDA kernel is held
to bit for bit on the card (``test_torch_kernels_cuda.py``). Counts must
agree bin for bin; the entropies at ``tests/test_kernels.py``'s bars
(abs 1e-5, 1e-4 for n = 3001).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import entropy as ref_entropy
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.kernels.entropy_hist import hist_counts as ref_hist_counts

from repro_torch.core import entropy
from repro_torch.kernels import entropy_hist as eh
from repro_torch.kernels import ops
from repro_torch.launch import entropy_probe

SIZES = [1000, 3001, 5000, 100000]


def _sample(n, seed=19):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _range(x: np.ndarray, bins: int):
    """(lo, 1/width) as fp32 scalars: mu - 4 and bins / 8, as the
    reference's padding test takes them."""
    return np.float32(x.mean() - 4.0), np.float32(bins / 8.0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bins", [64, 256])
def test_hist_counts_match_reference_kernel(n, bins):
    x = _sample(n)
    lo, inv_w = _range(x, bins)
    want = np.asarray(ref_hist_counts(jnp.asarray(x), jnp.float32(lo),
                                      jnp.float32(inv_w), num_bins=bins))
    got = eh.hist_counts(torch.from_numpy(x), float(lo), float(inv_w),
                         num_bins=bins)
    assert got.dtype == torch.float32 and got.shape == (bins,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got.sum()) == n


def test_hist_counts_clip_outliers_into_the_end_bins():
    x = _sample(5000)
    x[:3] = [1e30, -1e30, np.inf]
    got = eh.hist_counts(torch.from_numpy(x), -4.0, 32.0)
    want = np.asarray(ref_hist_counts(jnp.asarray(x), jnp.float32(-4.0),
                                      jnp.float32(32.0)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] >= 1 and got[-1] >= 2 and float(got.sum()) == 5000


def test_hist_counts_take_tensor_range_and_low_precision_samples():
    x = torch.from_numpy(_sample(3001)).to(torch.bfloat16)
    lo, inv_w = torch.tensor(-4.0), torch.tensor(32.0)
    got = eh.hist_counts(x, lo, inv_w)
    t = ((x.float() - lo) * inv_w).clamp(0, 255).long()
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(t.numpy(), minlength=256))


@pytest.mark.parametrize("n", SIZES)
def test_sampled_entropy_hist_matches_reference(n):
    x = _sample(n, seed=18)
    tol = 1e-4 if n == 3001 else 1e-5
    got = float(ops.sampled_entropy_hist(torch.from_numpy(x)))
    assert got == pytest.approx(float(ref_ops.sampled_entropy_hist(
        jnp.asarray(x))), abs=tol)
    assert got == pytest.approx(float(ref_oracle.sampled_entropy_hist(
        jnp.asarray(x))), abs=tol)
    assert float(entropy.histogram_entropy(torch.from_numpy(x))) == \
        pytest.approx(float(ref_oracle.sampled_entropy_hist(jnp.asarray(x))),
                      abs=tol)


@pytest.fixture(scope="module")
def probe_arrays():
    """The arrays ``examples/entropy_probe.py`` draws, in its order."""
    rng = np.random.default_rng(0)
    sigmas = {s: rng.standard_normal(200_000).astype(np.float32) * s
              for s in entropy_probe.SIGMAS}
    return sigmas, rng.standard_normal(1_000_000).astype(np.float32)


def test_probe_estimators_match_the_reference_example(probe_arrays):
    sigmas, big = probe_arrays
    for sigma, x in sigmas.items():
        got = entropy_probe.estimators(torch.from_numpy(x))
        xj = jnp.asarray(x)
        want = {"gaussian": ref_entropy.gaussian_entropy(xj),
                "hist": ref_entropy.histogram_entropy(xj),
                "kernel": ref_ops.sampled_entropy_hist(xj)}
        for key, w in want.items():
            assert got[key] == pytest.approx(float(w), abs=1e-5), (sigma, key)
    for beta in entropy_probe.BETAS:
        got = entropy.histogram_entropy(entropy.strided_sample(
            torch.from_numpy(big), beta))
        want = ref_entropy.histogram_entropy(ref_entropy.strided_sample(
            jnp.asarray(big), beta))
        assert float(got) == pytest.approx(float(want), abs=1e-5), beta


def test_probe_prints_every_line_on_the_cpu(capsys):
    lines = entropy_probe.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "entropy probe on cpu" and out[1:] == lines
    assert len(lines) == len(entropy_probe.SIGMAS) + len(entropy_probe.BETAS)
    assert all("kernel=" in line for line in lines[:3])
