"""Per-stage DP gradient sync: Algorithm 2's stage-aligned ranks.

Port of ``repro/pipeline/sync.py``. Each pipeline stage holds its own
gradients and syncs them over the data-parallel workers at the rank the
DAC assigned to ITS stage: one bucketed schedule (``core/bucketing.py``)
per distinct per-stage plan.

  * ``none`` / ``fixed`` / warm-up: every stage shares one plan, so one
    schedule.
  * ``edgc`` / ``optimus``: D <= S distinct rank assignments.

Each stage's program runs only the schedule of its own stage
(``d_of_stage[s]``); the reference runs all D on every rank and masks the
others, because one SPMD program cannot branch.

Compressor state keeps the reference's keys, ``p{d}:{group}`` per
distinct plan (and ``p{d}:ef:{path}`` under a coded wire), with a leading
stage dim: every stage carries a slice of every schedule's state, and only
the slice of its own schedule (the diagonal) is live. The port never
writes the other slices; the reference evolves them as masked-off values
it never reads back. The live state holds this worker's slices; a
checkpoint adds the per-worker dim after the stage dim, as the
reference's (S, W, ...) leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.core import bucketing
from repro_torch.core.bucketing import BucketLayout
from repro_torch.core.compressor import (CompressionPlan, LeafInfo,
                                         NO_COMPRESSION, leaf_wire_bytes)
from repro_torch.core.powersgd import (LowRankState, fold_in, init_leaf_state,
                                       resize_rank)
from repro_torch.pipeline.adapters import global_leaf_path, local_leaf_path

__all__ = [
    "StagePlans",
    "local_leaves_of",
    "stage_local_leaves",
    "make_stage_plans",
    "stage_sync_grads",
    "stage_sync_chunks",
    "sync_shared_grads",
    "stage_wire_bytes",
    "init_pipeline_comp_state",
    "resize_pipeline_comp_state",
    "replicate_pipeline_comp_state",
]

F32 = torch.float32
PsumFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StagePlans:
    """Static per-stage sync schedule: distinct local plans + layouts.

    ``stage_plans[s]`` is stage s's plan over stage-local leaf paths;
    ``distinct`` de-duplicates them (in order of first appearance),
    ``d_of_stage[s]`` indexes a stage's schedule, and ``layouts[d]`` is the
    bucketed sync layout each schedule executes.
    """

    num_stages: int
    stage_plans: tuple[CompressionPlan, ...]
    distinct: tuple[tuple[CompressionPlan, tuple[int, ...]], ...]
    d_of_stage: tuple[int, ...]
    layouts: tuple[BucketLayout, ...]

    def state_key(self, d: int, group_key: str) -> str:
        return f"p{d}:{group_key}"

    def predicted_collectives(self) -> tuple[int, ...]:
        """Per-stage collectives of one full sync pass (2 per stacked
        group + 1 per flat bucket of the stage's schedule)."""
        return tuple(self.layouts[self.d_of_stage[s]].num_collectives()
                     for s in range(self.num_stages))


def local_leaves_of(stage_tree: Any) -> list[tuple]:
    """(path, shape, itemsize) triples of a stage-local tree, flatten order."""
    return [(path, tuple(leaf.shape), leaf.element_size())
            for path, leaf in tree.flatten_with_path(stage_tree)]


def stage_local_leaves(stacked_tree: Any) -> list[tuple]:
    """Local (path, shape, itemsize) triples of a stage-stacked tree (the
    leading stage dim stripped): what one stage's gradient tree is."""
    return [(path, tuple(leaf.shape)[1:], leaf.element_size())
            for path, leaf in tree.flatten_with_path(stacked_tree)]


def make_stage_plans(
    plan: CompressionPlan,
    num_stages: int,
    local_leaves: list[tuple],
    bucket_bytes: int = bucketing.DEFAULT_BUCKET_BYTES,
    chunk_bytes: int = 0,
    local_path: Callable[[str], tuple[int, str] | None] = local_leaf_path,
) -> StagePlans:
    """Split a flat-layout plan into per-stage local plans + layouts.

    A pure function of (plan, leaf shapes). ``local_leaves`` comes from the
    adapter's stage-stacked template (``stage_local_leaves``): for ragged
    stage plans its shapes are the padded per-stage shapes, which is what
    each stage's schedule packs.
    """
    per_stage: list[list[tuple[str, int]]] = [[] for _ in range(num_stages)]
    for path, rank in plan.ranks:
        loc = local_path(path)
        if loc is None:
            raise ValueError(f"plan compresses non-stage leaf {path!r}; "
                             "shared leaves are excluded from compression")
        s, lp = loc
        if s >= num_stages:
            raise ValueError(f"leaf {path!r} names stage {s} >= {num_stages}")
        per_stage[s].append((lp, rank))
    stage_plans = tuple(CompressionPlan(ranks=tuple(r)) for r in per_stage)

    distinct: list[tuple[CompressionPlan, tuple[int, ...]]] = []
    d_of_stage: list[int] = []
    for s, sp in enumerate(stage_plans):
        for d, (p, stages) in enumerate(distinct):
            if p == sp:
                distinct[d] = (p, stages + (s,))
                d_of_stage.append(d)
                break
        else:
            d_of_stage.append(len(distinct))
            distinct.append((sp, (s,)))

    layouts = tuple(
        bucketing.make_bucket_layout(local_leaves, p, bucket_bytes,
                                     chunk_bytes)
        for p, _ in distinct
    )
    return StagePlans(
        num_stages=num_stages,
        stage_plans=stage_plans,
        distinct=tuple(distinct),
        d_of_stage=tuple(d_of_stage),
        layouts=layouts,
    )


# ------------------------------------------------------------------ executor
def _sub_state(comp: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in comp.items() if k.startswith(prefix)}


def stage_sync_grads(
    stage_grads: Any,
    shared_grads: Any,
    comp_state: dict,
    splans: StagePlans,
    psum_mean: PsumFn,
    my_stage: int,
    use_kernels: bool = False,
    codec=None,
) -> tuple[Any, Any, dict]:
    """Sync one stage's grads (+ the stage-summed shared grads) over DP.

    ``comp_state`` is the stage's slice of every schedule's state; only
    schedule ``d_of_stage[my_stage]`` runs, and only its keys change. With
    a ``codec`` every stage collective moves coded; the shared leaves stay
    raw. ``shared_grads=None`` skips the shared sync (a program that hosts
    several stages syncs them once). Returns (synced_stage, synced_shared,
    new_state).
    """
    d = splans.d_of_stage[my_stage]
    prefix = f"p{d}:"
    synced, st = bucketing.bucketed_sync_grads(
        stage_grads, _sub_state(comp_state, prefix), splans.layouts[d],
        psum_mean, use_kernels=use_kernels, codec=codec)
    new_state = dict(comp_state)
    new_state.update({prefix + k: v for k, v in st.items()})
    synced_shared = (None if shared_grads is None
                     else sync_shared_grads(shared_grads, psum_mean))
    return synced, synced_shared, new_state


def sync_shared_grads(shared_grads: Any, psum_mean: PsumFn) -> Any:
    """DP sync of the shared leaves (embeddings, head, norms): never
    compressed, so one flat-bucket schedule."""
    shared_layout = bucketing.layout_for_tree(shared_grads, NO_COMPRESSION)
    synced_shared, _ = bucketing.bucketed_sync_grads(
        shared_grads, {}, shared_layout, psum_mean)
    return synced_shared


def stage_sync_chunks(
    grads_by_path: dict[str, torch.Tensor],
    comp_state: dict,
    splans: StagePlans,
    d: int,
    chunk_ids,
    psum_mean: PsumFn,
    use_kernels: bool = False,
    codec=None,
) -> tuple[dict[str, torch.Tensor], dict]:
    """Run a subset of distinct schedule ``d``'s chunks (the overlap
    primitive).

    ``grads_by_path`` holds the stage's local gradients in the parameter
    dtype; only the chunks' members are read. Returns (synced leaves by
    local path, the full compressor dict with the touched ``p{d}:`` keys
    replaced).
    """
    prefix = f"p{d}:"
    sub = _sub_state(comp_state, prefix)
    chunks = bucketing.sync_chunks(splans.layouts[d])
    new_state = dict(comp_state)
    updates: dict[str, torch.Tensor] = {}
    for ci in chunk_ids:
        upd, st = bucketing.sync_chunk_grads(
            grads_by_path, sub, chunks[ci], psum_mean,
            use_kernels=use_kernels, codec=codec)
        updates.update(upd)
        new_state.update({prefix + k: v for k, v in st.items()})
    return updates, new_state


# ----------------------------------------------------------------- accounting
def stage_wire_bytes(leaves: list[LeafInfo], plan: CompressionPlan,
                     num_stages: int, bytes_per_elem: int = 2,
                     codec=None) -> list[tuple[int, int]]:
    """Per-stage (compressed, full) DP-sync bytes: Algorithm 2's ledger.

    Sums to ``plan_wire_bytes``; shared leaves are charged to the boundary
    stage ``_layer_stage`` pins them to. With a ``codec`` the compressed
    column is the coded payload and full stays the raw baseline.
    """
    out = [[0, 0] for _ in range(num_stages)]
    for info, (comp, full) in zip(leaves, leaf_wire_bytes(
            leaves, plan, bytes_per_elem, codec)):
        s = min(info.stage, num_stages - 1)
        out[s][0] += comp
        out[s][1] += full
    return [tuple(x) for x in out]


# ------------------------------------------------------------ state plumbing
def _stack(per_stage: list[dict], layout: BucketLayout) -> dict:
    stacks = [bucketing.stack_state(local, layout) for local in per_stage]
    return {gk: LowRankState(q=torch.stack([st[gk].q for st in stacks]),
                             err=torch.stack([st[gk].err for st in stacks]))
            for gk in stacks[0]}


def init_pipeline_comp_state(
    params: Any,
    plan: CompressionPlan,
    seed: int,
    splans: StagePlans,
    wire_ef: bool = False,
    device=None,
) -> dict:
    """Compressor state of the pipelined executor, leaves (S, ...).

    Per-leaf warm starts use the flat ``init_compressor_state``'s seeds
    (``fold_in(seed, global plan index)``), so the pipelined and flat
    trainers start from the same Q when the stage plan is uniform. Shapes
    come from the stage-local layouts (padded for ragged plans). A slice
    of a schedule its stage does not run is filled with the schedule's
    first stage's values, as the reference fills it. ``wire_ef`` adds
    zero fp32 residuals ``p{d}:ef:{path}`` for every flat-bucket member.
    """
    S = splans.num_stages
    if device is None:
        device = tree.leaves(params)[0].device
    flat_index = {path: i for i, (path, _) in enumerate(plan.ranks)}
    state: dict = {}
    if wire_ef:
        for d in range(len(splans.distinct)):
            for k, zeros in bucketing.init_flat_ef(splans.layouts[d],
                                                   device).items():
                state[splans.state_key(d, k)] = zeros.expand(
                    (S,) + tuple(zeros.shape)).clone()
    for d, (plan_d, stages_d) in enumerate(splans.distinct):
        if not plan_d.ranks:
            continue
        layout = splans.layouts[d]
        local_shapes = {p: shp for g in layout.groups for p, shp in g.members}
        per_stage = []
        for s in range(S):
            src = s if s in stages_d else stages_d[0]
            per_stage.append({
                lp: init_leaf_state(
                    local_shapes[lp], rank,
                    fold_in(seed, flat_index[global_leaf_path(src, lp)]),
                    F32, device)
                for lp, rank in plan_d.ranks})
        for gk, st in _stack(per_stage, layout).items():
            state[splans.state_key(d, gk)] = st
    return state


def replicate_pipeline_comp_state(state: dict, world: int) -> dict:
    """Insert the per-DP-worker dim AFTER the stage dim: (S, W, ...)."""
    return tree.tree_map(
        lambda a: a[:, None].expand((a.shape[0], world) + tuple(a.shape[1:])),
        state)


def resize_pipeline_comp_state(
    state: dict,
    old_splans: StagePlans,
    new_splans: StagePlans,
    seed: int,
    device,
) -> dict:
    """Migrate warm-start Q / EF across a DAC window re-plan.

    ``state`` leaves are (S, ...); each stage's live slice (its old
    schedule's) is resized per the new stage plan, as the flat trainer's
    plan change does: kept leaves keep Q (resized) and EF, new leaves start
    fresh. The new schedules' other slices copy their first stage's values.
    Fresh state goes on ``device``.
    """
    S = new_splans.num_stages

    per_stage_local: list[dict] = []
    per_stage_ef: list[dict] = []
    for s in range(S):
        d_old = old_splans.d_of_stage[s] if s < old_splans.num_stages else 0
        prefix = f"p{d_old}:"
        ef_prefix = prefix + bucketing.EF_PREFIX
        per_stage_ef.append({key[len(ef_prefix):]: v[s]
                             for key, v in state.items()
                             if key.startswith(ef_prefix)})
        old_sub = {key[len(prefix):]: LowRankState(q=v.q[s], err=v.err[s])
                   for key, v in state.items()
                   if key.startswith(prefix) and not key.startswith(ef_prefix)}
        per_leaf = (bucketing.unstack_state(old_sub, old_splans.layouts[d_old])
                    if old_sub else {})
        shapes = {p: shp
                  for g in new_splans.layouts[new_splans.d_of_stage[s]].groups
                  for p, shp in g.members}
        fresh = {}
        for i, (lp, rank) in enumerate(new_splans.stage_plans[s].ranks):
            sub = fold_in(seed, s * 100_003 + i)
            fresh[lp] = (resize_rank(per_leaf[lp], rank, sub) if lp in per_leaf
                         else init_leaf_state(shapes[lp], rank, sub, F32,
                                              device))
        per_stage_local.append(fresh)

    out: dict = {}
    for d, (plan_d, stages_d) in enumerate(new_splans.distinct):
        if not plan_d.ranks:
            continue
        per_stage = [
            {lp: per_stage_local[s if s in stages_d else stages_d[0]][lp]
             for lp, _ in plan_d.ranks} for s in range(S)]
        for gk, st in _stack(per_stage, new_splans.layouts[d]).items():
            out[new_splans.state_key(d, gk)] = st

    # Wire-EF entries: kept where the member stayed in a flat bucket at the
    # same local shape, zeros where it entered or left compression.
    if any(bucketing.EF_PREFIX in k for k in state):
        for d, (plan_d, stages_d) in enumerate(new_splans.distinct):
            for bucket in new_splans.layouts[d].buckets:
                for lp, shp in bucket.members:
                    slices = []
                    for s in range(S):
                        src = s if s in stages_d else stages_d[0]
                        old = per_stage_ef[src].get(lp)
                        if old is None or tuple(old.shape) != tuple(shp):
                            old = torch.zeros(shp, dtype=F32, device=device)
                        slices.append(old)
                    out[new_splans.state_key(d, bucketing.EF_PREFIX + lp)] = (
                        torch.stack(slices))
    return out
