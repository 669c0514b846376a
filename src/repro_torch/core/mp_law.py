"""Marchenko–Pastur law and the compression-error function g(r; m, n).

Paper Appendix A (Lemma 1 / Theorem 1): for a random gradient matrix
A in R^{m x n} (i.i.d. entries, mean 0, variance sigma^2), the eigenvalues
of A A^T follow the Marchenko–Pastur distribution; by Eckart–Young–Mirsky the
squared rank-r truncation error is the sum of the smallest m - r eigenvalues.
Theorem 1 estimates that sum by Monte-Carlo / quantile sampling of the MP CDF.

We expose:

  * ``mp_support(m, n)``      — [a, b] = [(sqrt(n)-sqrt(m))^2, (sqrt(n)+sqrt(m))^2]
  * ``mp_cdf(lam, m, n)``     — the closed-form CDF from Lemma 1
  * ``sample_eigenvalues``    — inverse-CDF sampling of the m eigenvalues
  * ``GTable``                — tabulated, invertible g(r) = E||A - A_r||_F
                                for unit-variance entries (Theorem 1)

All of this is host-side control-plane code (numpy): it runs once per
matrix shape at setup and never touches device state.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np

__all__ = [
    "mp_support",
    "mp_cdf",
    "sample_eigenvalues",
    "expected_sq_error",
    "GTable",
    "g_table",
]


def mp_support(m: int, n: int) -> tuple[float, float]:
    """Support [a, b] of the eigenvalues of A A^T, A in R^{m x n}, unit var.

    Lemma 1: a = (sqrt(n) - sqrt(m))^2, b = (sqrt(n) + sqrt(m))^2.
    (Requires m <= n; callers transpose to enforce it.)
    """
    a = (math.sqrt(n) - math.sqrt(m)) ** 2
    b = (math.sqrt(n) + math.sqrt(m)) ** 2
    return a, b


def mp_cdf(lam: np.ndarray, m: int, n: int) -> np.ndarray:
    """CDF of an eigenvalue of A A^T under the MP law (Lemma 1).

    F(lambda; m, n) = 1/(2 pi m) * F(lambda; a, b) with

      F(lam; a, b) = -2 sqrt(ab) * arctan( sqrt( b (lam - a) / (a (b - lam)) ) )
                     + (a + b) * arcsin( sqrt( (lam - a) / (b - a) ) )
                     + sqrt( (lam - a)(b - lam) )

    normalized so F(a) = 0 and F(b) = 1. The paper's constant 1/(2 pi m)
    matches the standard MP density integrated in the lambda' = lambda / n
    variable; we normalize numerically against F(b) to be safe for all
    (m, n) aspect ratios.
    """
    a, b = mp_support(m, n)
    lam = np.clip(np.asarray(lam, dtype=np.float64), a, b)

    def _raw(l: np.ndarray) -> np.ndarray:
        eps = 1e-12 * max(1.0, b)
        l = np.clip(l, a + eps, b - eps)
        t1 = -2.0 * math.sqrt(a * b) * np.arctan(
            np.sqrt(b * (l - a) / (max(a, eps) * (b - l)))
        ) if a > 0 else np.zeros_like(l)
        t2 = (a + b) * np.arcsin(np.sqrt((l - a) / (b - a)))
        t3 = np.sqrt((l - a) * (b - l))
        return t1 + t2 + t3

    raw = _raw(lam)
    lo = _raw(np.asarray([a + 1e-12]))[0]
    hi = _raw(np.asarray([b - 1e-12]))[0]
    return np.clip((raw - lo) / (hi - lo), 0.0, 1.0)


def _inverse_cdf_grid(m: int, n: int, grid: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Pairs {(lambda_0, p_0)} for Theorem 1 steps a-b.

    Quadratic spacing concentrates grid points near the lower edge a, where
    the MP density diverges for square-ish matrices (a -> 0, density ~
    lambda^-1/2) — a uniform grid badly resolves the small eigenvalues that
    dominate high-rank truncation errors.
    """
    a, b = mp_support(m, n)
    u = np.linspace(0.0, 1.0, grid)
    lam0 = a + (b - a) * u ** 2
    p0 = mp_cdf(lam0, m, n)
    return lam0, p0


def sample_eigenvalues(
    m: int,
    n: int,
    *,
    stratified: bool = True,
    rng: np.random.Generator | None = None,
    grid: int = 4096,
) -> np.ndarray:
    """Theorem 1 step c: draw m eigenvalues of A A^T by inverse-CDF sampling.

    ``stratified=True`` uses the quantile mid-points p_i = (i + 0.5)/m —
    a deterministic low-variance version of the paper's uniform draws
    (the paper draws p ~ U(0,1)); ``stratified=False`` reproduces the paper's
    randomized variant exactly.
    """
    lam0, p0 = _inverse_cdf_grid(m, n, grid)
    if stratified:
        p = (np.arange(m, dtype=np.float64) + 0.5) / m
    else:
        if rng is None:
            rng = np.random.default_rng(0)
        p = rng.uniform(0.0, 1.0, size=m)
    # interpolate p -> lambda through the (p0, lam0) pairs
    lam = np.interp(p, p0, lam0)
    return np.sort(lam)


def expected_sq_error(r: int, m: int, n: int, lam_sorted: np.ndarray | None = None) -> float:
    """Theorem 1 step d: E ||A - A_r||_F^2 = sum of the smallest m - r eigenvalues."""
    if lam_sorted is None:
        lam_sorted = sample_eigenvalues(m, n)
    r = int(np.clip(r, 0, m))
    return float(np.sum(lam_sorted[: m - r]))


@dataclasses.dataclass(frozen=True)
class GTable:
    """Tabulated g(r) = E||A - A_r||_F for a unit-variance m x n matrix.

    g is strictly decreasing in r (g(m) = 0), so it is invertible on [0, m]:
    ``rank_for_error`` returns the smallest rank whose expected error is at
    most the target — the conservative choice (errs toward accuracy).
    Theorem 3 is then

        r1 = g^{-1}( exp(H0 - H1) * g(r0) ).
    """

    m: int
    n: int
    g: np.ndarray  # shape (m + 1,): g[r] for r = 0..m

    def __call__(self, r: int) -> float:
        r = int(np.clip(r, 0, self.m))
        return float(self.g[r])

    def rank_for_error(self, eps: float) -> int:
        """Smallest r with g(r) <= eps (monotone inverse of g)."""
        # g is descending; searchsorted on the reversed array.
        idx = np.searchsorted(self.g[::-1], eps, side="right")
        r = self.m - idx + 1
        return int(np.clip(r, 0, self.m))

    def theorem3_rank(self, r0: int, h0: float, h1: float) -> int:
        """r1 = g^{-1}(e^{H0-H1} g(r0))  (paper Eq. 15)."""
        target = math.exp(h0 - h1) * self(r0)
        return self.rank_for_error(target)


@lru_cache(maxsize=512)
def g_table(m: int, n: int) -> GTable:
    """Build (and cache) the g(r) table for an m x n gradient matrix.

    Callers should pass m <= n (transpose otherwise): PowerSGD factors and
    Eckart–Young both operate on min(m, n) singular values.
    """
    if m > n:
        m, n = n, m
    lam = sample_eigenvalues(m, n)
    # prefix sums: csum[k] = sum of the k smallest eigenvalues, so the
    # expected squared rank-r error is sq_err[r] = csum[m - r].
    csum = np.concatenate([[0.0], np.cumsum(lam)])
    sq_err = csum[::-1]  # sq_err[r] = csum[m - r], r = 0..m
    g = np.sqrt(np.maximum(sq_err, 0.0))
    return GTable(m=m, n=n, g=g)
