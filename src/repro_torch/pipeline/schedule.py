"""GPipe / 1F1B microbatch schedules: the tick tables and their analytics.

Port of the pure-Python half of ``repro/pipeline/schedule.py``; the step
that executes these tables is :mod:`repro_torch.pipeline.executor`.

  tick grids (F = forward of microbatch j at stage s, B = its backward)

    gpipe :  F at  t = j + s            B at  t = 2M + 2S - 3 - j - s
             all forwards, then all backwards in reverse: M in-flight
             boundary activations per stage.
    1f1b  :  F at  t = j + s            B at  t = j + (2S - 1 - s)
             stage S-1 starts draining one tick after its first forward:
             in-flight activations bounded by min(M, 2S) per stage.

How much a forward tick keeps for its backward is the stash policy:

  replay   only the stage's boundary input survives the forward tick; the
           backward replays the whole stage (with per-unit remat inside
           when the step asks for remat).
  full     every inter-unit carry is stashed; the backward runs one
           segment per unit from its stashed input.
  every_k  every ``stash_every``-th unit boundary is stashed; segments
           replay at most k units from the nearest stash.

Both schedules leave stage s's last backward s ticks before stage 0's:
the per-stage slack Algorithm 2 (Eq. 4) converts into larger ranks.
``simulate_schedule`` generalizes the unit-tick analytics to measured
(t_F, t_B) tick costs, and ``plan_overlap`` places sync chunks into the
drain ticks (the planner; its execution is the overlapped sync).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import bucketing
from repro_torch.core.comm_model import ring_allreduce_seconds
from repro_torch.pipeline.adapters import boundary_leaves

__all__ = [
    "SCHEDULES",
    "STASH_POLICIES",
    "slot_table",
    "tick_count",
    "ring_slots",
    "first_bwd_tick",
    "bubble_fraction",
    "peak_inflight",
    "sync_slack_ticks",
    "last_backward_tick",
    "sync_ticks",
    "OverlapPlan",
    "plan_overlap",
    "overlap_branch_psums",
    "stash_points",
    "stash_segments",
    "tick_spans",
    "peak_activation_bytes",
    "policy_tick_cost",
    "boundary_nbytes",
    "simulate_schedule",
]

SCHEDULES = ("gpipe", "1f1b")
STASH_POLICIES = ("replay", "full", "every_k")


def tick_count(name: str, S: int, M: int) -> int:
    if name == "gpipe":
        return 2 * (M + S - 1)
    if name == "1f1b":
        return M + 2 * S - 1
    raise ValueError(f"unknown schedule {name!r} (want one of {SCHEDULES})")


def ring_slots(name: str, S: int, M: int) -> int:
    """Boundary-activation ring size: the schedule's in-flight bound."""
    return M if name == "gpipe" else min(M, 2 * S)


def _fwd_mb(t: int, s: int) -> int:
    return t - s


def _bwd_mb(name: str, t: int, s: int, S: int, M: int) -> int:
    if name == "gpipe":
        return (2 * M + 2 * S - 3) - t - s
    return t - (2 * S - 1) + s


def first_bwd_tick(name: str, S: int, M: int) -> int:
    return (M + S - 1) if name == "gpipe" else S


def slot_table(name: str, S: int, M: int,
               sync_plan: "OverlapPlan | None" = None) -> list[list[tuple]]:
    """table[s][t] = tuple of ("F"|"B", microbatch) actions at that tick.

    With a ``sync_plan`` (``plan_overlap``), each stage's row also carries
    ("S", chunk_id) entries at the ticks where that stage's DP-sync chunks
    launch.
    """
    n = tick_count(name, S, M)
    table: list[list[tuple]] = [[() for _ in range(n)] for _ in range(S)]
    for s in range(S):
        for t in range(n):
            acts = []
            if t < M + S - 1:
                j = _fwd_mb(t, s)
                if 0 <= j < M:
                    acts.append(("F", j))
            if t >= first_bwd_tick(name, S, M):
                j = _bwd_mb(name, t, s, S, M)
                if 0 <= j < M:
                    acts.append(("B", j))
            table[s][t] = tuple(acts)
    if sync_plan is not None:
        for s in range(S):
            for t, chunk_ids in sync_plan.launches[s]:
                table[s][t] = table[s][t] + tuple(
                    ("S", ci) for ci in chunk_ids)
    return table


def bubble_fraction(S: int, M: int) -> float:
    """Idle fraction of the classic unit-slot model, (S-1)/(M+S-1).

    GPipe and (non-interleaved) 1F1B share it: the schedules differ in
    peak activation memory and when sync slack opens, not in idle time.
    """
    return (S - 1) / (M + S - 1)


def peak_inflight(name: str, S: int, M: int) -> list[int]:
    """Max simultaneously-saved boundary activations per stage (+1 at each
    F, -1 at each B of the tick table)."""
    table = slot_table(name, S, M)
    peaks = []
    for s in range(S):
        live = peak = 0
        for acts in table[s]:
            for kind, _ in acts:
                if kind not in ("F", "B"):   # "S" sync entries hold no slot
                    continue
                live += 1 if kind == "F" else -1
                peak = max(peak, live)
        peaks.append(peak)
    return peaks


def sync_slack_ticks(name: str, S: int, M: int) -> list[int]:
    """Ticks between stage s's last backward and stage 0's (Alg 2 slack)."""
    last_b = last_backward_tick(name, S, M)
    return [last_b[0] - last_b[s] for s in range(S)]


def last_backward_tick(name: str, S: int, M: int) -> list[int]:
    """Tick of stage s's last microbatch backward: after it the stage's
    gradient accumulator is final, so its DP sync may launch next tick."""
    table = slot_table(name, S, M)
    return [max(t for t, acts in enumerate(table[s])
                if any(k == "B" for k, _ in acts)) for s in range(S)]


def sync_ticks(name: str, S: int, M: int) -> list[tuple[int, ...]]:
    """Per-stage ticks eligible to carry sync work: strictly after the
    stage's last backward, within the tick table (stage 0 gets none)."""
    last_b = last_backward_tick(name, S, M)
    n = tick_count(name, S, M)
    return [tuple(range(last_b[s] + 1, n)) for s in range(S)]


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """Schedule-interleaved sync plan emitted by ``plan_overlap``.

    ``launches[s]``: ``(tick, chunk_ids)`` pairs, the ``sync_chunks`` of
    stage s's layout launched at that tick. ``residual[s]``: chunk ids that
    did not fit the drain window and run after the loop. ``feasible[s]``:
    does stage s's estimated sync time fit ``est_sync_seconds[0] +
    slack_seconds[s]`` (the Eq. 4 signal the DAC consumes)?
    """

    schedule: str
    num_stages: int
    num_microbatches: int
    launches: tuple          # per stage: ((tick, (chunk_id, ...)), ...)
    residual: tuple          # per stage: (chunk_id, ...)
    slack_seconds: tuple     # per stage, from simulate_schedule
    est_sync_seconds: tuple  # per stage, CommModel estimate (or tick units)
    feasible: tuple          # per stage: bool

    def launch_ticks(self, s: int) -> tuple[int, ...]:
        return tuple(t for t, _ in self.launches[s])


def plan_overlap(name: str, S: int, M: int, splans, *,
                 t_f: float = 1.0, t_b: float = 1.0,
                 comm=None, codec=None) -> OverlapPlan:
    """Plan which sync chunks launch at which drain ticks.

    Greedy per stage: walk the stage's eligible drain ticks front to back
    and pack chunks into each tick until its budget (``t_b``) is spent;
    the rest spills to the post-loop residual. Chunk times come from the
    fitted ``CommModel`` when given (ring all-reduce of the chunk's wire
    bytes over the model's link bandwidth), else one tick each.
    """
    sim = simulate_schedule(name, S, M, t_f, t_b)
    slack = sim["slack_seconds"]
    ticks = sync_ticks(name, S, M)
    launches, residual, est = [], [], []
    for s in range(S):
        d = splans.d_of_stage[s]
        chunks = bucketing.sync_chunks(splans.layouts[d])
        if comm is not None:
            times = [ring_allreduce_seconds(c.wire_bytes(codec=codec),
                                            comm.world,
                                            comm.hw.ici_bw) for c in chunks]
        else:
            times = [t_b] * len(chunks)
        est.append(sum(times))
        per_tick: list[list[int]] = [[] for _ in ticks[s]]
        rest: list[int] = []
        ti, used = 0, 0.0
        for ci, ct in enumerate(times):
            if ti >= len(per_tick):
                rest.append(ci)
                continue
            per_tick[ti].append(ci)
            used += ct
            if used >= t_b - 1e-12:
                ti, used = ti + 1, 0.0
        launches.append(tuple((ticks[s][i], tuple(ids))
                              for i, ids in enumerate(per_tick) if ids))
        residual.append(tuple(rest))
    return OverlapPlan(
        schedule=name, num_stages=S, num_microbatches=M,
        launches=tuple(launches), residual=tuple(residual),
        slack_seconds=tuple(float(t) for t in slack),  # lint: allow(host-call-in-hot-path) host-side planner, never in the step
        est_sync_seconds=tuple(est),
        feasible=tuple(est[s] <= est[0] + slack[s] + 1e-9
                       for s in range(S)),
    )


def overlap_branch_psums(oplan: OverlapPlan, splans
                         ) -> tuple[tuple[tuple[int, tuple[int, ...]], ...],
                                    tuple[int, ...]]:
    """Collectives each stage launches per launch tick, and after the loop.

    Returns ``(in_loop, residual)``: ``in_loop`` is ``((tick, (count_stage0,
    ..., count_stageS-1)), ...)`` in tick order, each count the chunks'
    ``num_collectives`` summed; ``residual`` the post-loop counts.
    """
    chunks_by_d = tuple(bucketing.sync_chunks(l) for l in splans.layouts)

    def n_of(s: int, ids) -> int:
        d = splans.d_of_stage[s]
        return sum(chunks_by_d[d][ci].num_collectives for ci in ids)

    launch_at: dict[int, dict[int, tuple[int, ...]]] = {}
    for s in range(oplan.num_stages):
        for t, ids in oplan.launches[s]:
            launch_at.setdefault(t, {})[s] = ids
    in_loop = tuple(
        (t, tuple(n_of(s, launch_at[t].get(s, ()))
                  for s in range(oplan.num_stages)))
        for t in sorted(launch_at))
    residual = tuple(n_of(s, oplan.residual[s])
                     for s in range(oplan.num_stages))
    return in_loop, residual


def stash_points(policy: str, n_units: int, stash_every: int = 2
                 ) -> tuple[int, ...]:
    """Interior unit boundaries the forward tick stashes.

    ``replay`` stashes nothing; ``full`` every inter-unit carry; ``every_k``
    the multiples of ``stash_every`` strictly inside ``(0, n_units)``.
    """
    if policy == "replay":
        return ()
    if policy == "full":
        return tuple(range(1, n_units))
    if policy == "every_k":
        return tuple(range(max(1, stash_every), n_units,
                           max(1, stash_every)))
    raise ValueError(
        f"unknown stash policy {policy!r} (want one of {STASH_POLICIES})")


def stash_segments(policy: str, n_units: int, stash_every: int = 2
                   ) -> tuple[tuple[int, int], ...]:
    """Consecutive unit spans between stash points: what the backward
    replays per segment. ``replay`` is one whole-stage span."""
    bounds = (0,) + stash_points(policy, n_units, stash_every) + (n_units,)
    return tuple(zip(bounds[:-1], bounds[1:]))


def peak_activation_bytes(name: str, S: int, M: int, policy: str, *,
                          boundary_bytes: int, n_units: int,
                          stash_every: int = 2) -> list[int]:
    """Per-stage peak bytes of the saved-activation rings.

    Each F tick saves one boundary entry plus ``len(stash_points)`` stash
    entries for its microbatch and the matching B tick frees them, so the
    live entry count per stage peaks at ``peak_inflight``; every entry is
    one boundary activation (``boundary_bytes``).
    """
    n_stash = len(stash_points(policy, n_units, stash_every))
    per_mb = boundary_bytes * (1 + n_stash)
    return [p * per_mb for p in peak_inflight(name, S, M)]


def policy_tick_cost(t_f: float, t_b: float, policy: str,
                     remat: bool = False) -> float:
    """Backward-tick cost per stash policy: the pure backward ``t_b`` plus
    one stage forward replayed, twice under replay with per-unit remat."""
    if policy not in STASH_POLICIES:
        raise ValueError(
            f"unknown stash policy {policy!r} (want one of {STASH_POLICIES})")
    replay_cost = t_f * (2.0 if (policy == "replay" and remat) else 1.0)
    return t_b + replay_cost


def boundary_nbytes(part, mb: dict) -> int:
    """Bytes of one boundary activation (all its tensors) for one
    microbatch.

    ``mb`` maps batch keys to per-microbatch tensors (or anything with a
    ``shape``); ``part`` is the family's stage adapter.
    """
    return sum(math.prod(sp.shape)
               * torch.empty((), dtype=sp.dtype).element_size()
               for sp in boundary_leaves(part.boundary_spec(mb)))


def tick_spans(name: str, S: int, M: int,
               t_f: float = 1.0, t_b: float = 1.0) -> list[dict]:
    """Per-action spans of the dependency-driven event simulation.

    One dict per tick-table F/B entry, ``{"stage", "tick", "kind", "mb",
    "start", "end"}``: each F(s, j) waits for F(s-1, j) and the stage's
    previous op; each B(s, j) waits for B(s+1, j) (or its own F on the
    last stage).
    """
    table = slot_table(name, S, M)
    end_f: dict[tuple[int, int], float] = {}
    end_b: dict[tuple[int, int], float] = {}
    free = [0.0] * S
    spans: list[dict] = []
    for t in range(tick_count(name, S, M)):
        for s in range(S):
            for kind, j in table[s][t]:
                if kind == "F":
                    dep = end_f.get((s - 1, j), 0.0) if s > 0 else 0.0
                    start = max(free[s], dep)
                    end_f[(s, j)] = free[s] = start + t_f
                else:
                    dep = (end_b.get((s + 1, j), 0.0) if s < S - 1
                           else end_f[(s, j)])
                    dep = max(dep, end_f[(s, j)])
                    start = max(free[s], dep)
                    end_b[(s, j)] = free[s] = start + t_b
                spans.append({"stage": s, "tick": t, "kind": kind,
                              "mb": j, "start": start, "end": free[s]})
    return spans


def simulate_schedule(name: str, S: int, M: int,
                      t_f: float = 1.0, t_b: float = 1.0,
                      splans=None, comm=None) -> dict:
    """Dependency-driven timing of a schedule with measured tick costs.

    Returns ``{"makespan", "bubble_fraction", "slack_seconds"}`` (Eq. 4
    slack per stage, in seconds); with t_f == t_b == 1 it degenerates to
    ``bubble_fraction`` and ``sync_slack_ticks``. With ``splans`` it also
    plans the overlap: ``out["overlap"]`` is ``plan_overlap``'s plan under
    these tick costs.
    """
    spans = tick_spans(name, S, M, t_f, t_b)
    makespan = max(sp["end"] for sp in spans)
    busy = M * (t_f + t_b)
    last_b = [max(sp["end"] for sp in spans
                  if sp["stage"] == s and sp["kind"] == "B")
              for s in range(S)]
    out = {
        "makespan": makespan,
        "bubble_fraction": 1.0 - busy / makespan,
        "slack_seconds": [last_b[0] - last_b[s] for s in range(S)],
    }
    if splans is not None:
        out["overlap"] = plan_overlap(name, S, M, splans,
                                      t_f=t_f, t_b=t_b, comm=comm)
    return out
