"""DAC — Dynamic Alignment Compressor (paper §IV-D, Algorithms 1 and 2).

Host-side control plane. Owns:

  * rank bounds [r_min, r_max] from the comm model (Eq. 2 / footnote 1),
  * the adaptive warm-up decision (§IV-D2),
  * window-based rank adjustment for pipeline stage 1 (Algorithm 1),
  * stage-aligned rank adjustment for stages i > 1 (Algorithm 2, Eq. 4).

Nothing here touches device state: DAC consumes scalar entropy readings
(produced on-device by GDS) and emits per-stage integer ranks; the trainer
re-specializes the compiled step only when the rank vector changes
(window-level, as the paper prescribes to amortize "memory reallocation").
"""
from __future__ import annotations

import dataclasses

from .comm_model import CommModel
from .cqm import CQM

__all__ = ["DACConfig", "window_rank_adjust", "stage_aligned_ranks", "DAC"]


@dataclasses.dataclass(frozen=True)
class DACConfig:
    window: int = 1000            # w, iterations per adjustment window (Tab. VII)
    adjust_limit: int = 2         # s, max |rank delta| per window (Constraint 2)
    warmup_frac_min: float = 0.10  # empirical floor on the warm-up phase
    r_min_divisor: float = 5.0    # r_min = r_max / divisor, in [4, 6]
    quantize_to: int = 2          # snap ranks to multiples (bounds compile cache)


def window_rank_adjust(
    r_prev: int,
    r_new: int,
    r_min: int,
    r_max: int,
    s: int,
) -> int:
    """Algorithm 1 lines 3-10: limit the per-window move to ±s and clamp.

    ``r_new`` is the Theorem-3 (Eq. 11/15) rank computed by CQM from the
    window-mean entropy; the output is the applied rank for stage 1.
    """
    if abs(r_new - r_prev) > s:
        r_new = r_prev + s if r_new > r_prev else r_prev - s
    return max(r_min, min(r_max, r_new))


def stage_aligned_ranks(
    r_stage1: int,
    num_stages: int,
    comm: CommModel,
    t_micro_back: float,
    r_min: int,
    r_max: int,
    slack_seconds: list | None = None,
) -> list[int]:
    """Algorithm 2: align all stages' comm completion with stage 1 (Eq. 4).

    Stage 1 starts its DP sync last (its backward finishes last in 1F1B);
    stage i has an (i-1) * T_microBack head start, so it can afford
    T_com(r^{s1}) + (i-1) * T_microBack of communication — i.e. a *larger*
    (more accurate) rank — and still finish with stage 1.

    ``slack_seconds`` (0-indexed per stage, entry 0 ignored) replaces the
    analytic ``(i-1) * t_micro_back`` head start with the overlap planner's
    measured Eq. 4 slack (``simulate_schedule``'s calibrated event times):
    the rank vector then reflects what the schedule-interleaved sync can
    actually hide, not the unit-tick idealization. With
    ``slack_seconds[s] == s * t_micro_back`` (the unit model) the two
    formulations coincide exactly.
    """
    t1 = comm.t_com(r_stage1)
    ranks = [r_stage1]
    for i in range(2, num_stages + 1):
        head = (slack_seconds[i - 1] if slack_seconds is not None
                else (i - 1) * t_micro_back)
        t_i = t1 + head
        ranks.append(comm.rank_for_time(t_i, r_min, r_max))
    return ranks


@dataclasses.dataclass
class DAC:
    """Stateful per-training-run DAC instance.

    One CQM anchors the entropy->rank law (on the representative — largest —
    compressed shape, as the paper's layer-invariance observation justifies:
    relative error trends are consistent across layers, Fig. 10).
    """

    cqm: CQM
    comm: CommModel
    cfg: DACConfig
    r_min: int
    r_max: int
    num_stages: int
    t_micro_back: float
    total_iterations: int

    # mutable control state
    warmed_up: bool = False
    r_stage1: int = 0
    window_index: int = 0
    # per-stage ranks actually APPLIED last window (Constraint 2 is a
    # bound on the applied move, so every stage — not just stage 1 —
    # tracks its previous value); None until the first post-warm-up update
    applied_ranks: list | None = None
    # Overlap feedback (set via set_overlap): the planner's measured
    # per-stage Eq. 4 slack in seconds. When present it (a) replaces the
    # analytic (i-1)*t_micro_back head start in stage alignment and
    # (b) turns on the feasibility clamp — a stage's applied rank is
    # lowered until its comm fits T_com(r_stage1) + slack, so the rank
    # vector trades rank for OVERLAP FEASIBILITY, not just raw bytes.
    slack_seconds: list | None = None

    def __post_init__(self) -> None:
        self.r_stage1 = self.r_max

    def set_overlap(self, slack_seconds) -> None:
        """Feed the overlap planner's per-stage Eq. 4 slack (seconds).

        ``slack_seconds[s]`` is how long before stage 0's last backward
        stage s's last backward retires (``simulate_schedule(...)
        ["slack_seconds"]``, possibly calibrated with measured t_f/t_b).
        Must be per-stage, non-negative, with stage 0 at zero slack.
        """
        slack = [float(t) for t in slack_seconds]
        if len(slack) != self.num_stages:
            raise ValueError(f"slack_seconds has {len(slack)} entries, "
                             f"DAC drives {self.num_stages} stages")
        if any(t < 0 for t in slack):
            raise ValueError(f"negative Eq. 4 slack: {slack}")
        self.slack_seconds = slack

    def _feasible_clamp(self, ranks: list[int]) -> list[int]:
        """Lower any stage's rank until its comm fits its overlap budget.

        Budget = T_com(r_stage1) + slack_s (Eq. 4 with measured slack).
        Like the [r_min, r_max] bounds this is a Constraint-1-style hard
        limit, applied after the ±adjust_limit window: an infeasible rank
        would push the stage's sync past stage 0's and stall the pipeline,
        so feasibility wins over move smoothness (downward only — the
        clamp never raises a rank).
        """
        if self.slack_seconds is None:
            return ranks
        q = max(1, self.cfg.quantize_to)
        t1 = self.comm.t_com(ranks[0])
        out = [ranks[0]]
        for s in range(1, len(ranks)):
            budget = t1 + self.slack_seconds[s]
            r = ranks[s]
            while r - q >= self.r_min and self.comm.t_com(r) > budget:
                r -= q
            out.append(max(self.r_min, r))
        return out

    def _snap_limited(self, r: int, r_prev: int) -> int:
        """Quantize to the rank grid WITHOUT leaving the ±adjust_limit
        window around ``r_prev``: the snap happens INSIDE the clamp, so
        the applied move can never exceed ``adjust_limit`` (the old
        clamp-then-round order could emit adjust_limit + quantize_to/2,
        a Constraint-2 violation). Rank bounds still win last — they are
        Constraint 1."""
        q = max(1, self.cfg.quantize_to)
        s = self.cfg.adjust_limit
        rq = round(r / q) * q
        if rq > r_prev + s:
            rq -= q * (-(-(rq - (r_prev + s)) // q))     # ceil-div steps
            if rq < r_prev - s:
                rq = r_prev   # no grid point in the window (q > 2s): hold
        elif rq < r_prev - s:
            rq += q * (-(-((r_prev - s) - rq) // q))
            if rq > r_prev + s:
                rq = r_prev
        return max(self.r_min, min(self.r_max, rq))

    # -- §IV-D2: adaptive warm-up -------------------------------------------
    def maybe_end_warmup(self, h_window: float, step: int) -> bool:
        """End warm-up when the Theorem-3 rank first drops below r_max, but
        never before 10% of total iterations (the empirical constraint)."""
        if self.warmed_up:
            return True
        if step < self.cfg.warmup_frac_min * self.total_iterations:
            return False
        if not self.cqm.anchored:
            # anchor the fixed-error constraint at (r_max, current entropy)
            self.cqm.anchor(self.r_max, h_window)
            return False
        r_new = self.cqm.rank_for_entropy(h_window)
        if r_new < self.r_max:
            self.warmed_up = True
            self.r_stage1 = self.r_max
        return self.warmed_up

    # -- Algorithm 1 + 2 ------------------------------------------------------
    def update(self, h_window: float) -> list[int]:
        """Per-window update: new per-stage rank vector (stage 1 first).

        Quantization happens INSIDE the Constraint-2 clamp for every
        stage: the Theorem-3 target is first limited to ±adjust_limit of
        the stage's previously APPLIED rank, then snapped to the rank
        grid without leaving that window (``_snap_limited``). Monotone
        clamps over monotone previous/target vectors keep the Algorithm-2
        non-decreasing-over-stages invariant intact.
        """
        self.window_index += 1
        if not self.cqm.anchored:
            self.cqm.anchor(self.r_max, h_window)
        prev = list(self.applied_ranks or [self.r_max] * self.num_stages)
        r_new = self.cqm.rank_for_entropy(h_window)
        r1 = window_rank_adjust(
            prev[0], r_new, self.r_min, self.r_max, self.cfg.adjust_limit
        )
        r1 = self._snap_limited(r1, prev[0])
        self.r_stage1 = r1
        ranks = stage_aligned_ranks(
            r1, self.num_stages, self.comm, self.t_micro_back,
            self.r_min, self.r_max, slack_seconds=self.slack_seconds,
        )
        out = [r1]
        for i in range(1, self.num_stages):
            r_i = window_rank_adjust(
                prev[i], ranks[i], self.r_min, self.r_max,
                self.cfg.adjust_limit
            )
            out.append(self._snap_limited(r_i, prev[i]))
        out = self._feasible_clamp(out)
        self.applied_ranks = out
        return list(out)

    def current_ranks(self) -> list[int]:
        if self.applied_ranks is not None:
            return list(self.applied_ranks)
        return self._feasible_clamp(stage_aligned_ranks(
            self.r_stage1, self.num_stages, self.comm, self.t_micro_back,
            self.r_min, self.r_max, slack_seconds=self.slack_seconds,
        ))
