"""EDGCController — ties GDS + CQM + DAC together over the training run.

The trainer drives it every iteration:

  * ``wants_entropy(step)`` is GDS's alpha gate: whether entropy is measured
    this iteration (the measurement itself is the on-device, beta-sampled
    ``grads_entropy``), and ``on_entropy`` takes the reading;
  * ``on_window_end`` feeds the window-mean entropy to the DAC:
      - during warm-up: the adaptive warm-up check (§IV-D2),
      - after: Algorithm 1 (+ stage alignment, Algorithm 2),
    producing a new per-stage rank vector and hence a new CompressionPlan;
  * the trainer re-lays out the compressor state iff the plan changed.

All controller state is host-side Python; the only device work it requests
is the alpha-gated scalar entropy. Port of ``repro/core/controller.py``;
the analytic comm model reads ``EDGCConfig.hw`` (H100 SXM by default).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .comm_model import H100_SXM, CommModel, HardwareSpec, rank_bounds
from .compressor import (
    NO_COMPRESSION,
    CompressionPlan,
    LeafInfo,
    make_plan,
)
from .config import alias_property, resolve_embedded
from .cqm import CQM
from .dac import DAC, DACConfig
from .entropy import GDSConfig

__all__ = ["EDGCConfig", "EDGCController"]


@dataclasses.dataclass(frozen=True, init=False)
class EDGCConfig:
    """EDGC policy configuration.

    The execution knobs live in the embedded configs: ``pipeline``
    (``repro_torch.pipeline.PipelineConfig`` — ``num_stages``, schedule, overlap)
    and ``sync`` (``repro_torch.core.SyncConfig`` — bucketing, kernels). The old
    flat fields (``num_stages``, ``use_kernels``) are accepted as init
    kwargs and readable as properties, deprecated in favor of
    ``cfg.pipeline.num_stages`` / ``cfg.sync.use_kernels``.
    """

    policy: str = "edgc"          # none | fixed | optimus | edgc
    fixed_rank: int = 64          # for the fixed / optimus baselines
    gds: GDSConfig = GDSConfig()
    dac: DACConfig = DACConfig()
    total_iterations: int = 10_000
    mxu_efficiency: float = 0.35  # for the analytic comm/compute model
    hw: HardwareSpec = H100_SXM   # device peaks for the analytic model
    pipeline: Any = None          # PipelineConfig (resolved in __init__)
    sync: Any = None              # SyncConfig (resolved in __init__)

    def __init__(self, policy: str = "edgc", fixed_rank: int = 64,
                 gds: GDSConfig | None = None, dac: DACConfig | None = None,
                 total_iterations: int = 10_000, mxu_efficiency: float = 0.35,
                 hw: HardwareSpec = H100_SXM, pipeline=None, sync=None,
                 **legacy) -> None:
        pipeline, sync = resolve_embedded(pipeline, sync, legacy,
                                          where="EDGCConfig")
        set_ = lambda k, v: object.__setattr__(self, k, v)
        set_("policy", policy)
        set_("fixed_rank", fixed_rank)
        set_("gds", gds if gds is not None else GDSConfig())
        set_("dac", dac if dac is not None else DACConfig())
        set_("total_iterations", total_iterations)
        set_("mxu_efficiency", mxu_efficiency)
        set_("hw", hw)
        set_("pipeline", pipeline)
        set_("sync", sync)


# Deprecated flat-field aliases (kept for existing call sites/tests).
EDGCConfig.num_stages = alias_property("pipeline", "num_stages")
EDGCConfig.use_kernels = alias_property("sync", "use_kernels")


class EDGCController:
    """Host-side orchestration of the EDGC policy (and the baselines)."""

    def __init__(
        self,
        cfg: EDGCConfig,
        leaves: list[LeafInfo],
        world: int,
        t_micro_back: float | None = None,
    ) -> None:
        self.cfg = cfg
        self.leaves = leaves
        self.world = world

        eligible = [l for l in leaves if l.eligible]
        if not eligible and cfg.policy != "none":
            raise ValueError("no compressible leaves; use policy='none'")

        # Analytic comm model over the eligible population (Eq. 2-3).
        shapes = []
        for l in eligible:
            m, n = l.shape[-2:]
            reps = l.shape[0] if len(l.shape) == 3 else 1
            shapes.extend([(m, n)] * reps)
        self.comm = CommModel.from_shapes(
            shapes or [(1, 1)], world=world, hw=cfg.hw,
            mxu_efficiency=cfg.mxu_efficiency,
        )

        # Representative shape for the CQM anchor: the largest eligible
        # matrix (layer-invariance, Fig. 10, lets one law drive all stages).
        if eligible:
            rep = max(eligible, key=lambda l: l.shape[-2] * l.shape[-1])
            m, n = sorted(rep.shape[-2:])
            max_possible = m // 2
        else:
            m, n, max_possible = 64, 64, 32
        self.cqm = CQM(m=m, n=n)

        self.r_min, self.r_max = rank_bounds(
            self.comm, max_possible, cfg.dac.r_min_divisor
        )

        # Analytic per-stage backprop time if not measured (see DESIGN §3).
        if t_micro_back is None:
            t_micro_back = self.comm.t_com(max(1, (self.r_max - self.r_min) // 4))
        self.dac = DAC(
            cqm=self.cqm,
            comm=self.comm,
            cfg=cfg.dac,
            r_min=self.r_min,
            r_max=self.r_max,
            num_stages=cfg.num_stages,
            t_micro_back=t_micro_back,
            total_iterations=cfg.total_iterations,
        )

        # entropy bookkeeping
        self._window_h: list[float] = []
        self._history: list[tuple[int, float]] = []     # (step, entropy)
        self._rank_history: list[tuple[int, list[int]]] = []
        self._fallback = False   # recovery: pin to uncompressed sync
        self._plan = self._initial_plan()

    # ------------------------------------------------------------------ plans
    def _initial_plan(self) -> CompressionPlan:
        p = self.cfg.policy
        if p == "none":
            return NO_COMPRESSION
        if p in ("fixed", "optimus"):
            return make_plan(
                p, self.leaves, fixed_rank=self.cfg.fixed_rank,
                num_stages=self.cfg.num_stages,
            )
        # EDGC starts in warm-up: no compression until DAC says go.
        return NO_COMPRESSION

    @property
    def plan(self) -> CompressionPlan:
        return self._plan

    @property
    def in_warmup(self) -> bool:
        return self.cfg.policy == "edgc" and not self.dac.warmed_up

    @property
    def in_fallback(self) -> bool:
        return self._fallback

    def force_fallback(self) -> bool:
        """Recovery policy: pin the plan to uncompressed sync permanently.

        Called by the trainer after repeated anomalies (non-finite steps,
        loss spikes): if aggressive compression is the suspected cause, the
        safe terminal state is a plain all-reduce. Window ends stop
        producing plans; the flag survives checkpoints. Returns True iff
        the plan changed (the trainer then re-lays out its state).
        """
        self._fallback = True
        changed = self._plan != NO_COMPRESSION
        self._plan = NO_COMPRESSION
        return changed

    def set_overlap_feedback(self, slack_seconds) -> None:
        """Feed the overlap planner's per-stage Eq. 4 slack, in seconds.

        The trainer calls this on a pipelined run with ``overlap_sync``;
        the DAC then aligns ranks against the schedule's geometry and
        lowers any stage whose comm would not fit its overlap budget
        (``DAC._feasible_clamp``): Algorithm 2 trading rank for overlap.
        """
        self.dac.set_overlap(slack_seconds)

    # ------------------------------------------------------------------ hooks
    def wants_entropy(self, step: int) -> bool:
        """The ISR (alpha) gate — the trainer dispatches an entropy-OFF
        compiled step variant when False, so skipped iterations lower no
        moment work at all (§IV-B measures entropy on a FRACTION of
        iterations). The gate is a GDS sampling property, not an EDGC-
        policy one: baselines keep the same schedule so their
        observational entropy histories stay comparable."""
        return self.cfg.gds.should_measure(step % self.cfg.dac.window)

    def on_entropy(self, step: int, h: float) -> None:
        self._window_h.append(float(h))
        self._history.append((step, float(h)))

    def on_window_end(self, step: int) -> bool:
        """Called every ``window`` steps. Returns True iff the plan changed."""
        if self._fallback or self.cfg.policy != "edgc" or not self._window_h:
            self._window_h.clear()
            return False
        h_mean = float(np.mean(self._window_h))
        self._window_h.clear()

        old_plan = self._plan
        if not self.dac.warmed_up:
            self.dac.maybe_end_warmup(h_mean, step)
            if not self.dac.warmed_up:
                return False
            stage_ranks = [self.r_max] * self.cfg.num_stages
        else:
            stage_ranks = self.dac.update(h_mean)
        self._rank_history.append((step, stage_ranks))
        self._plan = make_plan(
            "edgc", self.leaves, stage_ranks=stage_ranks,
            num_stages=self.cfg.num_stages,
        )
        return self._plan != old_plan

    # --------------------------------------------------------- checkpointing
    def state_dict(self) -> dict[str, Any]:
        """JSON-serializable control-plane state, in the reference's format.

        Everything the window loop mutates: the DAC warm-up flag, stage-1
        rank, window index and applied ranks, the CQM anchor, the entropy
        and rank histories, the partial window and the current plan.
        """
        return {
            "policy": self.cfg.policy,
            "dac": {
                "warmed_up": bool(self.dac.warmed_up),
                "r_stage1": int(self.dac.r_stage1),
                "window_index": int(self.dac.window_index),
                "applied_ranks": (None if self.dac.applied_ranks is None
                                  else [int(r) for r in
                                        self.dac.applied_ranks]),
            },
            "cqm": {"h_anchor": self.cqm._h_anchor,
                    "g_anchor": self.cqm._g_anchor},
            "window_h": [float(h) for h in self._window_h],
            "entropy_history": [[int(s), float(h)] for s, h in self._history],
            "rank_history": [[int(s), [int(r) for r in rs]]
                             for s, rs in self._rank_history],
            "plan": [[p, int(r)] for p, r in self._plan.ranks],
            "fallback": bool(self._fallback),
        }

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        if sd.get("policy") != self.cfg.policy:
            raise ValueError(
                f"checkpoint controller policy {sd.get('policy')!r} != "
                f"configured {self.cfg.policy!r}")
        self.dac.warmed_up = bool(sd["dac"]["warmed_up"])
        self.dac.r_stage1 = int(sd["dac"]["r_stage1"])
        self.dac.window_index = int(sd["dac"]["window_index"])
        ar = sd["dac"].get("applied_ranks")
        self.dac.applied_ranks = None if ar is None else [int(r) for r in ar]
        h, g = sd["cqm"]["h_anchor"], sd["cqm"]["g_anchor"]
        self.cqm._h_anchor = None if h is None else float(h)
        self.cqm._g_anchor = None if g is None else float(g)
        self._window_h = [float(x) for x in sd["window_h"]]
        self._history = [(int(s), float(x)) for s, x in sd["entropy_history"]]
        self._rank_history = [(int(s), [int(r) for r in rs])
                              for s, rs in sd["rank_history"]]
        self._plan = CompressionPlan(
            ranks=tuple((p, int(r)) for p, r in sd["plan"]))
        self._fallback = bool(sd.get("fallback", False))

    # ------------------------------------------------------------- reporting
    @property
    def entropy_history(self) -> list[tuple[int, float]]:
        return list(self._history)

    @property
    def rank_history(self) -> list[tuple[int, list[int]]]:
        return list(self._rank_history)

    def describe(self) -> dict[str, Any]:
        return {
            "policy": self.cfg.policy,
            "r_min": self.r_min,
            "r_max": self.r_max,
            "eta_s_per_rank": self.comm.eta,
            "warmed_up": not self.in_warmup,
            "stage_ranks": self.dac.current_ranks() if not self.in_warmup else [],
            "num_compressed_leaves": len(self._plan.ranks),
        }
