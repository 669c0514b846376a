"""CQM — Compression Quantification Model (paper §IV-C, Appendix A).

Ties gradient entropy to compression rank:

  Theorem 1  g(r; m, n)     expected truncation error, unit variance (mp_law)
  Lemma  2   H = log(sigma) + 0.5 log(2 pi e)
  Theorem 2  r1 = g^{-1}((sigma0/sigma1) g(r0))   fixed absolute error
  Theorem 3  r1 = g^{-1}(e^{H0-H1} g(r0))         via Lemma 2

The CQM object is per gradient-matrix-shape; the controller owns one per
compressed leaf shape (they are cached by shape in mp_law.g_table).
"""
from __future__ import annotations

import dataclasses
import math


from .mp_law import GTable, g_table

__all__ = ["CQM", "theoretical_error", "rank_from_entropy_delta"]


def theoretical_error(r: int, m: int, n: int, sigma: float = 1.0) -> float:
    """E||A - A_r||_F for an m x n i.i.d. matrix with entry std ``sigma``.

    Observation 3 predicts the *actual* error of real LLM gradients sits
    below this (correlation ⇒ faster spectral decay); tests assert that.
    """
    if m > n:
        m, n = n, m
    return sigma * g_table(m, n)(r)


def rank_from_entropy_delta(r0: int, h0: float, h1: float, m: int, n: int) -> int:
    """Theorem 3 (Eq. 15): the rank that keeps the absolute error fixed."""
    if m > n:
        m, n = n, m
    return g_table(m, n).theorem3_rank(r0, h0, h1)


@dataclasses.dataclass
class CQM:
    """Entropy -> rank control law for one matrix shape (m <= n enforced).

    ``anchor(r, h)`` pins the fixed-error constraint epsilon_ini = g(r)*sigma(h)
    at compression activation (Constraint 1 / §IV-D2); ``rank_for_entropy(h)``
    then returns the Theorem-3 rank for any later entropy reading. Anchoring
    once (rather than chaining window-to-window deltas) avoids compounding
    integer-quantization drift; both reduce to Eq. 15 exactly when ranks are
    continuous.
    """

    m: int
    n: int
    _table: GTable = dataclasses.field(init=False, repr=False)
    _h_anchor: float | None = dataclasses.field(default=None, init=False)
    _g_anchor: float | None = dataclasses.field(default=None, init=False)

    def __post_init__(self) -> None:
        if self.m > self.n:
            self.m, self.n = self.n, self.m
        self._table = g_table(self.m, self.n)

    # -- Constraint 1: fix the absolute error at activation time ------------
    def anchor(self, r0: int, h0: float) -> None:
        self._h_anchor = float(h0)
        self._g_anchor = self._table(r0)

    @property
    def anchored(self) -> bool:
        return self._h_anchor is not None

    def rank_for_entropy(self, h1: float) -> int:
        """Theorem 3 against the anchored (r0, H0)."""
        if not self.anchored:
            raise RuntimeError("CQM.anchor() must be called before rank_for_entropy")
        target = math.exp(self._h_anchor - float(h1)) * self._g_anchor
        return self._table.rank_for_error(target)

    def step_rank(self, r_prev: int, h_prev: float, h_new: float) -> int:
        """One-shot Theorem 3 from (r_prev, h_prev) -> h_new (windowed form)."""
        return self._table.theorem3_rank(r_prev, h_prev, h_new)

    def error_at(self, r: int, sigma: float = 1.0) -> float:
        return sigma * self._table(r)

    def max_rank(self) -> int:
        return self.m
