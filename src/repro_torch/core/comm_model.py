"""Communication-time model and rank bounds (paper §IV-D1, Fig. 9, Eq. 2-3).

Port of ``repro/core/comm_model.py``. PowerSGD rank-r compression of an
m x n gradient moves (m + n) * r elements through the ring, and ring
all-reduce time is 2 (k-1)/k * bytes / link_bw, so T_com(r) = eta * r.

The default :class:`HardwareSpec` is the NVIDIA H100 SXM data sheet:
989e12 dense bf16 FLOP/s, 3.35e12 B/s HBM3, and 450e9 B/s of NVLink each
way. ``CommModel.fit`` recovers eta from measured (rank, seconds) samples.

Eq. 2 gates compression: it only pays when
    T_compress + D_compressed / B + T_decompress <= D_original / B
which yields r_max; r_min defaults into the paper's [r_max/6, r_max/4] band.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["HardwareSpec", "H100_SXM", "CommModel", "rank_bounds"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-device peak numbers (defaults: H100 SXM data sheet).

    Field names follow the reference's spec so one spec converts to the
    other field for field; ``ici_bw`` is the inter-device link rate, here
    NVLink's 450 GB/s each way.
    """

    peak_flops: float = 989e12          # dense bf16 FLOP/s per device
    hbm_bw: float = 3.35e12             # bytes/s per device
    ici_bw: float = 450e9               # bytes/s per link direction
    bytes_per_elem: int = 2             # bf16 on the wire


H100_SXM = HardwareSpec()


def ring_allreduce_seconds(nbytes: float, world: int, link_bw: float) -> float:
    """Classic ring all-reduce: 2 (k-1)/k * nbytes / link_bw."""
    if world <= 1:
        return 0.0
    return 2.0 * (world - 1) / world * nbytes / link_bw


@dataclasses.dataclass
class CommModel:
    """T_com(r) = eta * r for one compressed leaf population (Eq. 3)."""

    eta: float                      # seconds per unit rank
    overhead_per_rank: float = 0.0  # compress+decompress seconds per unit rank
    full_bytes: float = 0.0         # D_original in bytes (for Eq. 2)
    world: int = 1
    hw: HardwareSpec = H100_SXM

    @classmethod
    def from_shapes(
        cls,
        shapes: list[tuple[int, int]],
        world: int,
        hw: HardwareSpec = H100_SXM,
        mxu_efficiency: float = 0.35,
    ) -> "CommModel":
        """Analytic eta for a set of compressed (m, n) leaves.

        Per unit rank, PowerSGD ships (m + n) elements per leaf and spends
        ~ 2*(2 m n) FLOPs (M@Q and M^T@P) on compress + ~2 m n on decompress;
        ``mxu_efficiency`` is the fraction of the matrix-unit peak reached.
        """
        bpe = hw.bytes_per_elem
        bytes_per_rank = sum((m + n) * bpe for m, n in shapes)
        eta = ring_allreduce_seconds(bytes_per_rank, world, hw.ici_bw)
        flops_per_rank = sum(6.0 * m * n for m, n in shapes)
        overhead = flops_per_rank / (hw.peak_flops * mxu_efficiency)
        full = sum(m * n * bpe for m, n in shapes)
        return cls(eta=eta, overhead_per_rank=overhead, full_bytes=full,
                   world=world, hw=hw)

    @classmethod
    def fit(cls, ranks: np.ndarray, seconds: np.ndarray) -> tuple["CommModel", float]:
        """Least-squares fit of T = eta*r from measurements; returns (model, MAPE)."""
        ranks = np.asarray(ranks, dtype=np.float64)
        seconds = np.asarray(seconds, dtype=np.float64)
        eta = float(np.sum(ranks * seconds) / np.sum(ranks * ranks))
        pred = eta * ranks
        mape = float(np.mean(np.abs(pred - seconds) / np.maximum(seconds, 1e-12)))
        return cls(eta=eta), mape

    def t_com(self, r: int) -> float:
        return self.eta * r

    def t_total(self, r: int) -> float:
        """Eq. 2 LHS: compress + wire + decompress."""
        return self.overhead_per_rank * r + self.t_com(r)

    def t_uncompressed(self) -> float:
        """Eq. 2 RHS: D_original / B as a ring all-reduce."""
        return ring_allreduce_seconds(self.full_bytes, self.world, self.hw.ici_bw)

    def rank_for_time(self, t: float, r_min: int, r_max: int) -> int:
        """Invert Eq. 3 (used by stage alignment, Alg. 2 line 4)."""
        if self.eta <= 0:
            return r_max
        return int(np.clip(round(t / self.eta), r_min, r_max))


def rank_bounds(model: CommModel, max_possible: int,
                r_min_divisor: float = 5.0) -> tuple[int, int]:
    """(r_min, r_max) from Eq. 2 + the paper's footnote-1 band."""
    t_full = model.t_uncompressed()
    if t_full <= 0:
        return 1, max(1, max_possible)
    r_max = max_possible
    per_rank = model.overhead_per_rank + model.eta
    if per_rank > 0:
        r_max = int(t_full / per_rank)
    r_max = int(np.clip(r_max, 1, max_possible))
    r_min = max(1, int(round(r_max / r_min_divisor)))
    return r_min, r_max
