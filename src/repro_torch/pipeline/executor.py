"""The pipelined train step: one stage's program, driven tick by tick.

Port of ``make_pipeline_train_step`` (``repro/pipeline/schedule.py``).
Each stage runs the tick table of ``schedule.slot_table``:

  * forward ticks (``t < M + S - 1``): stage 0 embeds its microbatch, the
    others take the boundary activation sent at the previous tick; the
    stage runs its units under ``torch.no_grad()``, the last stage adds
    the head loss, and the microbatch's boundary input (and, under the
    ``full``/``every_k`` stash policies, the stashed inter-unit carries)
    go into slot ``j % R`` of the stage's ring; y moves forward;
  * backward ticks (``t >= first_bwd_tick``): the stage re-runs each stash
    segment back to front from its saved input and pulls the cotangents
    (the received boundary cotangent, and 1/M on the loss) through
    ``torch.autograd.grad``; parameter gradients accumulate in fp32 and
    the input cotangent moves back.

Off-schedule ticks do no work (the reference adds exact zeros there).
After the loop: gradients cast to the parameter dtype, the shared
gradients summed over the stages (the tied embedding gets stage 0's embed
part and stage S-1's head part), the per-stage DP sync, the Gaussian
entropy from moment vectors over S slots (shared leaves counted once, on
stage 0), the global gradient norm, and AdamW on ``{"stage", "shared"}``.

With ``overlap_sync`` the per-stage sync is split into the chunks of
``bucketing.sync_chunks`` and launched in the drain: at each tick that
``schedule.plan_overlap`` gives a hosted stage (always after its last
backward), the stage casts those chunks' fp32 accumulators to the
parameter dtype and runs them (``SyncExecutor.run_chunks``); the chunks
the plan left over (all of stage 0's, whose slack is zero) run after the
loop, and the synced leaves are reassembled in flatten order. The chunks
of a layout partition it, so the result equals the monolithic sync bit
for bit. On CUDA the in-loop chunks run on a side stream, which waits for
an event recorded after the stage's last backward: the counterpart of the
reference's asynchronous collectives, so that a stage's sync can run
while other stages compute. The compute stream waits for the side stream
at the end of the loop. ``step.sync_launches`` lists the last step's
launches as ``(tick, stage, chunk ids)``, tick -1 after the loop.

A boundary is one tensor, or a dict of tensors (Whisper's ``{"mem",
"x"}``): the sends, receives, stash ring and cotangents take its leaves
in sorted-key order, and a one-tensor boundary keeps its one-tensor path.

The pipe collectives come from a transport, as the DP mean comes from an
injected ``psum_mean``:

  * :class:`LocalPipe` hosts all S stage programs in one process on one
    device: within tick t every stage computes, then the sends are
    delivered for tick t+1. One card carries S stages this way, one after
    another (so it shows the executor's work, not the pipeline's overlap).
  * :class:`DistPipe` hosts one stage per process: ``torch.distributed``
    point-to-point (``batch_isend_irecv``, one message per boundary leaf)
    between neighbours, and an all-reduce over the pipe group.

A step's state holds the hosted stages' slices: ``stage_params`` and the
stage halves of ``opt_m``/``opt_v`` lead with (H, Lmax, ...) and the
compressor state with (H, ...), H = ``len(pipe.stages)``. On a mesh with a
``model`` axis the parameters and moments are DTensors on the model group
and everything the schedule moves or accumulates is local
(``_ModelAxis``).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import tree
from repro_torch.core import powersgd
from repro_torch.core.config import SyncConfig
from repro_torch.core.entropy import entropy_from_moments, sample_moments
from repro_torch.core.powersgd import LowRankState
from repro_torch.core.sync_executor import SyncExecutor
from repro_torch.dist import sharding, tp
from repro_torch.dist.collectives import make_dp_pmean
from repro_torch.models.model import Model
from repro_torch.optim import adam
from repro_torch.pipeline import schedule as sched
from repro_torch.pipeline import sync as psync
from repro_torch.pipeline.adapters import boundary_leaves, boundary_unflatten
from repro_torch.pipeline.partition import make_partition

__all__ = ["LocalPipe", "DistPipe", "make_pipeline_train_step", "host_state"]

F32 = torch.float32


# ---------------------------------------------------------------- transports
def _zeros32(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(like.shape, dtype=F32, device=like.device)


class LocalPipe:
    """All S stage programs in one process: sends made during tick t are
    delivered at its end, for tick t + 1."""

    def __init__(self, num_stages: int) -> None:
        self.num_stages = num_stages
        self.stages = tuple(range(num_stages))
        self._out: dict[tuple[str, int], torch.Tensor] = {}
        self._in: dict[tuple[str, int], torch.Tensor] = {}

    def send_fwd(self, s: int, y: torch.Tensor) -> None:
        self._out[("f", s + 1)] = y

    def send_bwd(self, s: int, ct: torch.Tensor) -> None:
        self._out[("b", s - 1)] = ct

    def deliver(self, expect: set, spec, device) -> None:
        """End of a tick: what was sent becomes receivable. ``expect`` is
        the set of ("f"|"b", stage) receives the tick table implies."""
        if self._in:
            raise RuntimeError(f"undelivered pipe messages {sorted(self._in)}")
        if set(self._out) != expect:
            raise RuntimeError(f"pipe sends {sorted(self._out)} do not match "
                               f"the tick table's {sorted(expect)}")
        self._in, self._out = self._out, {}

    def recv_fwd(self, s: int) -> torch.Tensor:
        return self._in.pop(("f", s))

    def recv_bwd(self, s: int) -> torch.Tensor:
        return self._in.pop(("b", s))

    def psum_pipe(self, parts: dict[int, torch.Tensor | None],
                  like: torch.Tensor) -> torch.Tensor:
        """Sum over the stages of each stage's fp32 part; a stage with no
        part (None) adds zero, and with none at all the sum is fp32 zeros
        shaped like ``like``. A part may be returned or written as the
        sum."""
        vals = [parts[s] for s in self.stages if parts.get(s) is not None]
        if not vals:
            return _zeros32(like)
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out


class DistPipe:
    """One stage per process: stage s is rank s of ``group`` (the default
    group when None). Sends and receives of a tick are posted together
    with ``batch_isend_irecv`` and waited for at its end."""

    def __init__(self, num_stages: int, group=None) -> None:
        size = dist.get_world_size(group)
        if size != num_stages:
            raise ValueError(f"pipe group has {size} ranks, "
                             f"num_stages={num_stages}")
        self.num_stages = num_stages
        self.group = group
        self.stage = dist.get_rank(group)
        self.stages = (self.stage,)
        self._sends: list[tuple[torch.Tensor, int]] = []
        self._in: dict[tuple[str, int], torch.Tensor] = {}

    def _peer(self, s: int) -> int:
        return s if self.group is None else dist.get_global_rank(self.group, s)

    def send_fwd(self, s: int, y) -> None:
        self._sends.extend((t.contiguous(), s + 1)
                           for t in boundary_leaves(y))

    def send_bwd(self, s: int, ct) -> None:
        self._sends.extend((t.contiguous(), s - 1)
                           for t in boundary_leaves(ct))

    def deliver(self, expect: set, spec, device) -> None:
        """Post the tick's sends and the receives ``expect`` implies, one
        message per boundary leaf of ``spec``, and wait for them."""
        if self._in:
            raise RuntimeError(f"undelivered pipe messages {sorted(self._in)}")
        ops = [dist.P2POp(dist.isend, t, self._peer(peer), self.group)
               for t, peer in self._sends]
        for kind, s in sorted(expect):
            bufs = [torch.empty(sp.shape, dtype=sp.dtype, device=device)
                    for sp in boundary_leaves(spec)]
            src = s - 1 if kind == "f" else s + 1
            ops.extend(dist.P2POp(dist.irecv, buf, self._peer(src), self.group)
                       for buf in bufs)
            self._in[(kind, s)] = boundary_unflatten(spec, bufs)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self._sends = []

    def recv_fwd(self, s: int) -> torch.Tensor:
        return self._in.pop(("f", s))

    def recv_bwd(self, s: int) -> torch.Tensor:
        return self._in.pop(("b", s))

    def psum_pipe(self, parts: dict[int, torch.Tensor | None],
                  like: torch.Tensor) -> torch.Tensor:
        """The all-reduce sums the tensors' storage in memory order, so a
        part with other strides (a transposed gradient, as the tied head
        gives) is made contiguous first."""
        out = parts.get(self.stage)
        out = _zeros32(like) if out is None else out.contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out


# ------------------------------------------------------------------- helpers
def host_state(state: dict, stages: tuple[int, ...]) -> dict:
    """The slices of a whole pipelined state (stage dims of size S) that a
    program hosting ``stages`` steps on."""
    idx = list(stages)
    take = lambda t: tree.tree_map(lambda a: a[idx], t)
    return {
        "stage_params": take(state["stage_params"]),
        "shared_params": state["shared_params"],
        "opt_m": {"stage": take(state["opt_m"]["stage"]),
                  "shared": state["opt_m"]["shared"]},
        "opt_v": {"stage": take(state["opt_v"]["stage"]),
                  "shared": state["opt_v"]["shared"]},
        "opt_step": state["opt_step"],
        "comp": take(state["comp"]),
    }


def _slice_comp(comp: dict, k: int) -> dict:
    return {key: (LowRankState(q=v.q[k], err=v.err[k])
                  if isinstance(v, LowRankState) else v[k])
            for key, v in comp.items()}


def _stack_comp(per_stage: list[dict]) -> dict:
    out = {}
    for key, v in per_stage[0].items():
        if isinstance(v, LowRankState):
            out[key] = LowRankState(
                q=torch.stack([c[key].q for c in per_stage]),
                err=torch.stack([c[key].err for c in per_stage]))
        else:
            out[key] = torch.stack([c[key] for c in per_stage])
    return out


def _inner(placements, lead: int) -> tuple:
    """The placements of an element of a stacked DTensor: every split dim
    ``lead`` dims lower."""
    return tuple(Shard(p.dim - lead) if isinstance(p, Shard) else p
                 for p in placements)


class _ModelAxis:
    """The stage program's side of a ``model`` mesh axis: parameters are
    DTensors on the model sub-mesh, and everything the schedule moves or
    accumulates is local. A boundary crosses the pipe as its whole
    (replicated) local tensor and is made a DTensor again where a stage
    reads it; gradients accumulate as fp32 local shards; a stage
    gradient is gathered whole over ``model`` before the per-stage sync,
    whose compressor state stays whole as the reference's does (GSPMD
    gathers the split gradients into it), and each rank keeps its own
    cut of the synced leaf. Without a mesh every method is the
    identity."""

    def __init__(self, mesh) -> None:
        self.mesh = (None if mesh is None or "model" not in mesh.mesh_dim_names
                     else mesh["model"])

    def read(self, b):
        """A received boundary (local tensors) as the stage reads it."""
        if self.mesh is None or b is None:
            return b
        rep = (Replicate(),)
        return boundary_unflatten(b, [
            DTensor.from_local(t, self.mesh, rep, run_check=False)
            for t in boundary_leaves(b)])

    @staticmethod
    def wire(b):
        """A stage's output boundary (or aux loss) as local whole tensors."""
        if b is None:
            return b
        return boundary_unflatten(b, [
            t.full_tensor() if isinstance(t, DTensor) else t
            for t in boundary_leaves(b)])

    @staticmethod
    def unit_leaf(a, k: int, i: int):
        """Element ``i`` of hosted stage ``k``'s stack ``a`` (H, Lmax, ...)
        as a leaf gradients are taken against."""
        if not isinstance(a, DTensor):
            return a[k, i].detach().requires_grad_(True)
        shape = torch.Size(a.shape[2:])
        return DTensor.from_local(
            a.to_local()[k, i].detach(), a.device_mesh,
            _inner(a.placements, 2), run_check=False, shape=shape,
            stride=sharding.contiguous_stride(shape)).requires_grad_(True)

    @staticmethod
    def grad(g, like) -> torch.Tensor:
        """A gradient's local shard, placed as its leaf."""
        return tp.local(tp.normalize_grad(g, like))

    @staticmethod
    def gather(t: torch.Tensor, like) -> torch.Tensor:
        """The whole of a stage leaf's local gradient ``t`` (shaped as
        ``like`` without its stage dim)."""
        if not isinstance(like, DTensor):
            return t
        shape = torch.Size(like.shape[1:])
        return DTensor.from_local(
            t, like.device_mesh, _inner(like.placements, 1), run_check=False,
            shape=shape, stride=sharding.contiguous_stride(shape)
        ).full_tensor()

    @staticmethod
    def cut(t: torch.Tensor, like) -> torch.Tensor:
        """This rank's cut of a whole synced stage leaf."""
        if not isinstance(like, DTensor):
            return t
        return sharding.local_chunk(t, _inner(like.placements, 1),
                                    like.device_mesh)


# -------------------------------------------------------------- step builder
def make_pipeline_train_step(model: Model, cfg, psum_mean=None, pipe=None,
                             mesh=None):
    """Pipelined train step: ``step(state, batch) -> (state, metrics)``.

    ``cfg`` is a ``train.step.TrainStepConfig``; ``pipe`` a transport
    (default ``LocalPipe(cfg.num_stages)``). State layout:

      stage_params  stage-stacked stacks, leaves (H, Lmax, ...)
      shared_params embeddings/head/norms
      opt_m/opt_v   {"stage": ..., "shared": ...} mirrors of the above
      opt_step      0-d int32
      comp          per-distinct-plan stacked compressor state, (H, ...)

    metrics = {loss, entropy, stage_entropy (S,), ef_norm, lr, grad_norm},
    tensors left on the device.

    ``mesh`` with a ``model`` axis (``(pipe, data, model)`` across
    processes with ``DistPipe``, or ``(data, model)`` with ``LocalPipe``):
    the stage and shared parameters and their moments are DTensors on the
    model sub-mesh (``train.step.distribute_state``) and the compressor
    state stays whole (see ``_ModelAxis``).
    """
    S = cfg.num_stages
    M = cfg.num_microbatches or S
    name = cfg.schedule
    if name not in sched.SCHEDULES:
        raise ValueError(f"unknown schedule {name!r} "
                         f"(want one of {sched.SCHEDULES})")
    if cfg.measure_entropy and cfg.gds.estimator != "gaussian":
        # the pipelined entropy is reassembled from summed sufficient
        # statistics, which only the Gaussian (Lemma 2) estimator admits
        raise ValueError(
            f"pipelined step supports the gaussian entropy estimator only, "
            f"got {cfg.gds.estimator!r}")
    stash = cfg.stash_policy
    if stash not in sched.STASH_POLICIES:
        raise ValueError(f"unknown stash policy {stash!r} "
                         f"(want one of {sched.STASH_POLICIES})")
    overlap = cfg.overlap_sync
    pipe = LocalPipe(S) if pipe is None else pipe
    if pipe.num_stages != S:
        raise ValueError(f"pipe transport has {pipe.num_stages} stages, "
                         f"step wants num_stages={S}")
    if psum_mean is None and isinstance(pipe, DistPipe):
        # the default DP mean spans the default group, which here holds the
        # pipe ranks: it would average the stages with one another
        raise ValueError("a DistPipe step needs an explicit psum_mean over "
                         "its data-parallel group (the identity for one "
                         "replica)")
    pmean = psum_mean or make_dp_pmean()
    # the stashed policies bound the backward's recompute by the segment,
    # so per-unit remat inside the stage is kept for replay only
    part = make_partition(model, S, remat=cfg.remat and stash == "replay")
    segs = sched.stash_segments(stash, part.num_units(), cfg.stash_every)
    last_seg = len(segs) - 1
    sync_cfg = cfg.sync or SyncConfig()
    R = sched.ring_slots(name, S, M)
    n_ticks = sched.tick_count(name, S, M)
    table = sched.slot_table(name, S, M)
    last_b = sched.last_backward_tick(name, S, M)
    inv_M = 1.0 / M
    hosted = pipe.stages
    built: dict[str, Any] = {}
    axis = _ModelAxis(mesh)

    def expected(t: int) -> set:
        """Receives the tick table implies at the end of tick t."""
        exp = set()
        for s in hosted:
            if s > 0 and any(k == "F" for k, _ in table[s - 1][t]):
                exp.add(("f", s))
            if s < S - 1 and any(k == "B" for k, _ in table[s + 1][t]):
                exp.add(("b", s))
        return exp

    def seg_fwd(s, units, shared, xin, mbj, i):
        """One stash segment of stage s: stage 0's first segment embeds,
        the last stage's last segment adds the head loss."""
        lo, hi = segs[i]
        with tp.model_context(axis.mesh is not None):
            if i == 0 and s == 0:
                xin = part.embed(shared, mbj)
            else:
                xin = axis.read(xin)
            y, contrib = part.blocks_segment(units, shared, xin, s, lo, hi)
            if i == last_seg and s == S - 1:
                contrib = contrib + part.head_loss(shared, y, mbj)
        return axis.wire(y), axis.wire(contrib)

    def step(state, batch):
        batch = dict(batch)
        if "_inject" in batch:
            raise ValueError("the pipelined step has no fault-injection "
                             "channel (nan_grad needs the flat trainer)")
        for k, v in batch.items():
            if v.shape[0] % M:
                raise ValueError(f"local batch {v.shape[0]} not divisible by "
                                 f"num_microbatches={M}")
        mb = {k: v.reshape((M, v.shape[0] // M) + tuple(v.shape[1:]))
              for k, v in batch.items()}
        take_mb = lambda j: {k: v[j] for k, v in mb.items()}
        device = state["opt_step"].device
        spec = part.boundary_spec(take_mb(0))
        stage_p = state["stage_params"]
        shared_p = state["shared_params"]
        if "splans" not in built:
            splans = psync.make_stage_plans(
                cfg.policy_plan, S, psync.stage_local_leaves(stage_p),
                bucket_bytes=sync_cfg.bucket_bytes,
                chunk_bytes=cfg.chunk_bytes,
                local_path=part.local_leaf_path)
            built["splans"] = splans
            built["sync"] = SyncExecutor(
                sync_cfg,
                mode="per-stage-overlapped" if overlap else "per-stage",
                splans=splans)
            # which drain tick launches which of a stage's chunks
            launch_at: dict[int, dict[int, tuple[int, ...]]] = {}
            if overlap:
                oplan = sched.plan_overlap(name, S, M, splans)
                for s_ in range(S):
                    for t_, ids_ in oplan.launches[s_]:
                        launch_at.setdefault(t_, {})[s_] = ids_
                built["residual"] = oplan.residual
                built["side"] = (torch.cuda.Stream(device)
                                 if device.type == "cuda" else None)
            built["launch_at"] = launch_at
        splans, sync_exec = built["splans"], built["sync"]
        launch_at = built["launch_at"]

        # the leaves gradients are taken against: per unit of each hosted
        # stage (padded units included), and the shared tree
        grad_leaf = lambda a: a.detach().requires_grad_(True)
        units, unit_leaves, leaf_unit, targets, gacc_s = {}, {}, {}, {}, {}
        for k, s in enumerate(hosted):
            units[s] = {key: [
                tree.tree_map(lambda a, i=i: axis.unit_leaf(a, k, i), sub)
                for i in range(tree.leaves(sub)[0].shape[1])]
                for key, sub in stage_p.items()}
            unit_leaves[s] = tree.leaves(units[s])
            local = tree.tree_map(lambda a: tp.local(a)[k], stage_p)
            gacc_s[s] = tree.tree_map(
                lambda a: torch.zeros(a.shape, dtype=F32, device=a.device),
                local)
            # unit leaf n is element i of its stack, which runs in the
            # stage's unit leaf_unit[n], and accumulates into the element's
            # slice of its stack
            order = [(part.unit_index(key, s, i), i, acc)
                     for key in sorted(local)
                     for i in range(len(units[s][key]))
                     for acc in tree.leaves(gacc_s[s][key])]
            leaf_unit[s] = [u for u, _, _ in order]
            targets[s] = [acc[i] for _, i, acc in order]
        del order
        shared = tree.tree_map(grad_leaf, shared_p)
        shared_leaves = tree.leaves(shared)
        gacc_sh: dict[int, list] = {s: [None] * len(shared_leaves)
                                    for s in hosted}
        loss_acc = {s: torch.zeros((), dtype=F32, device=device)
                    for s in hosted}
        ring: dict[int, list] = {s: [None] * R for s in hosted}
        ct_loss = torch.tensor(inv_M, dtype=F32, device=device)

        def forward_tick(s, j):
            x = None if s == 0 else pipe.recv_fwd(s)
            if ring[s][j % R] is not None:
                raise RuntimeError(f"stage {s}: ring slot {j % R} still holds "
                                   f"microbatch {ring[s][j % R][0]}")
            mbj, y, interior = take_mb(j), x, []
            with torch.no_grad():
                for i in range(len(segs)):
                    if i:
                        interior.append(y)
                    y, contrib = seg_fwd(s, units[s], shared, y, mbj, i)
                    loss_acc[s] = loss_acc[s] + contrib
            ring[s][j % R] = (j, x, interior)
            if s < S - 1:
                pipe.send_fwd(s, y)

        def backward_tick(s, j):
            saved_j, x_saved, stash_saved = ring[s][j % R]
            if saved_j != j:
                raise RuntimeError(f"stage {s}: ring slot {j % R} holds "
                                   f"microbatch {saved_j}, backward wants {j}")
            ring[s][j % R] = None
            mbj = take_mb(j)
            ct_carry = None if s == S - 1 else pipe.recv_bwd(s)
            for i in range(last_seg, -1, -1):
                lo, hi = segs[i]
                xin = x_saved if i == 0 else stash_saved[i - 1]
                takes_input = not (i == 0 and s == 0)
                seg_ids = [n for n, u in enumerate(leaf_unit[s])
                           if lo <= u < hi]
                seg_leaves = [unit_leaves[s][n] for n in seg_ids]
                with torch.enable_grad(), \
                        tp.model_context(axis.mesh is not None):
                    x_leaves = []
                    if takes_input:
                        x_leaves = [a.detach().requires_grad_(True)
                                    for a in boundary_leaves(xin)]
                        xin = boundary_unflatten(xin, x_leaves)
                    y, contrib = seg_fwd(s, units[s], shared, xin, mbj, i)
                    outs, cts = [], []
                    if ct_carry is not None:
                        outs.extend(boundary_leaves(y))
                        cts.extend(boundary_leaves(ct_carry))
                    if contrib.requires_grad:
                        outs.append(contrib)
                        cts.append(ct_loss)
                    inputs = seg_leaves + shared_leaves + x_leaves
                    grads = torch.autograd.grad(outs, inputs, cts,
                                                allow_unused=True)
                with torch.no_grad():
                    for n, g in zip(seg_ids, grads):
                        if g is not None:
                            targets[s][n].add_(axis.grad(
                                g, unit_leaves[s][n]).to(F32))
                    acc = gacc_sh[s]
                    for n, g in enumerate(grads[len(seg_leaves):
                                                len(seg_leaves)
                                                + len(shared_leaves)]):
                        if g is not None:
                            g = axis.grad(g, shared_leaves[n]).to(F32)
                            acc[n] = g if acc[n] is None else acc[n].add_(g)
                # a boundary leaf the segment never read (a padded decoder
                # unit's head reads no mem) gets a zero cotangent
                ct_carry = (boundary_unflatten(xin, [
                    torch.zeros_like(a) if g is None else g
                    for a, g in zip(x_leaves,
                                    grads[len(grads) - len(x_leaves):])])
                    if takes_input else None)
            if s > 0:
                pipe.send_bwd(s, ct_carry)

        comp = state["comp"]
        paths = [p for p, _ in tree.flatten_with_path(gacc_s[hosted[0]])]
        pdt = {p: a.dtype for p, a in
               zip(paths, tree.leaves(stage_p))}
        plike = dict(zip(paths, tree.leaves(stage_p)))
        # a stage gradient in the parameter dtype, whole over ``model``
        whole_grad = lambda p, g: axis.gather(g.to(pdt[p]), plike[p])
        # overlapped sync, per hosted stage: the fp32 accumulators by path
        # (taken at its first launch), the synced leaves and its slice of
        # the compressor state; on CUDA the event after its last backward
        side = built.get("side")
        accs, parts, comps, done = {}, {}, {}, {}
        launches: list[tuple[int, int, tuple[int, ...]]] = []

        def run_chunks(t, s, ids):
            """Stage s's chunks ``ids``: cast their members' accumulators
            to the parameter dtype and sync them over the DP workers."""
            if s not in accs:
                accs[s] = dict(zip(paths, tree.leaves(gacc_s[s])))
                parts[s] = {}
                comps[s] = _slice_comp(comp, hosted.index(s))
                # the stage's backward is done: drop its views into the
                # accumulators, so that syncing a chunk frees its members'
                for held in (units, unit_leaves, targets):
                    held.pop(s, None)
                gacc_s[s] = None
            d = splans.d_of_stage[s]
            chunks = sync_exec.chunks(d)
            need = [p for ci in ids for p in chunks[ci].member_paths]
            launches.append((t, s, tuple(ids)))
            if side is None or t < 0:
                gb = {p: whole_grad(p, accs[s].pop(p)) for p in need}
                upd, comps[s] = sync_exec.run_chunks(d, ids, gb, comps[s],
                                                     pmean)
            else:
                side.wait_event(done[s])
                with torch.cuda.stream(side):
                    for v in [accs[s][p] for p in need] + tree.leaves(comps[s]):
                        v.record_stream(side)
                    gb = {p: whole_grad(p, accs[s].pop(p)) for p in need}
                    upd, comps[s] = sync_exec.run_chunks(d, ids, gb,
                                                         comps[s], pmean)
            parts[s].update(upd)

        for t in range(n_ticks):
            for s in hosted:
                for kind, j in table[s][t]:
                    if kind == "F":
                        forward_tick(s, j)
                    else:
                        backward_tick(s, j)
                if side is not None and t == last_b[s]:
                    done[s] = torch.cuda.Event()
                    done[s].record()
            for s, ids in launch_at.get(t, {}).items():
                if s in hosted:
                    run_chunks(t, s, ids)
            pipe.deliver(expected(t), spec, device)
        # drop the views into the accumulators, so casting frees them
        for held in (units, unit_leaves, targets):
            held.clear()
        shared = shared_leaves = None

        with torch.no_grad():
            loss = pmean(pipe.psum_pipe(loss_acc, loss_acc[hosted[0]]) * inv_M)
            shared_grads = tree.unflatten(shared_p, [
                pipe.psum_pipe({s: gacc_sh[s][n] for s in hosted},
                               tp.local(p)).to(p.dtype)
                for n, p in enumerate(tree.leaves(shared_p))])
            del gacc_sh
            synced_s, comp2 = {}, []
            if overlap:
                if side is not None:
                    # the side stream's outputs are read from here on
                    compute = torch.cuda.current_stream(device)
                    compute.wait_stream(side)
                    for v in [x for s in parts for x in parts[s].values()] \
                            + tree.leaves(comps):
                        v.record_stream(compute)
                for s in hosted:
                    ids = built["residual"][s]
                    if ids or s not in accs:
                        run_chunks(-1, s, ids)
                    synced_s[s] = tree.unflatten(
                        stage_p, [parts[s].pop(p) for p in paths])
                    comp2.append(comps.pop(s))
                del accs, parts
            else:
                for k, s in enumerate(hosted):
                    grads = tree.unflatten(gacc_s[s], [
                        whole_grad(p, g) for p, g in
                        zip(paths, tree.leaves(gacc_s[s]))])
                    gacc_s[s] = None
                    synced_s[s], _, new_k = sync_exec.sync(
                        grads, _slice_comp(comp, k), pmean, my_stage=s)
                    comp2.append(new_k)
            del gacc_s
            comp2 = _stack_comp(comp2) if comp2[0] else {}
            # the shared leaves are never compressed: their DP mean runs on
            # the local shards (a mean commutes with the split)
            synced_sh = tree.tree_map(
                tp.rewrap, shared_p, sync_exec.sync_shared(shared_grads, pmean))
            del shared_grads

            zero = torch.zeros((), dtype=F32, device=device)
            if cfg.measure_entropy:
                # per-stage moments scattered into S slots and summed over
                # the stages: the pooled entropy and the per-stage series
                vecs = {}
                for s in hosted:
                    n1 = a1 = a2 = zero
                    for key in sorted(synced_s[s]):
                        kn, k1, k2 = sample_moments(
                            synced_s[s][key], cfg.gds,
                            lead_mask=part.stage_flags(key, s))
                        n1, a1, a2 = n1 + kn, a1 + k1, a2 + k2
                    if s == 0:     # shared leaves counted once
                        n2, c1, c2 = sample_moments(synced_sh, cfg.gds)
                        n1, a1, a2 = n1 + n2, a1 + c1, a2 + c2
                    v = torch.zeros((3, S), dtype=F32, device=device)
                    v[:, s] = torch.stack([n1, a1, a2]).to(device)
                    vecs[s] = v
                n_vec, s1_vec, s2_vec = pipe.psum_pipe(
                    vecs, torch.zeros((3, S), dtype=F32, device=device))
                entropy = entropy_from_moments(n_vec.sum(), s1_vec.sum(),
                                               s2_vec.sum())
                stage_entropy = entropy_from_moments(n_vec, s1_vec, s2_vec)
            else:
                entropy = zero
                stage_entropy = torch.zeros((S,), dtype=F32, device=device)

            gnorm = torch.sqrt(
                pipe.psum_pipe({s: adam.sum_squares(synced_s[s])
                                for s in hosted}, zero)
                + adam.sum_squares(synced_sh))
            # every rank synced the whole stage leaves; it keeps its cut
            per_stage = [tree.leaves(synced_s[s]) for s in hosted]
            synced_stack = tree.unflatten(stage_p, [
                tp.rewrap(like, torch.stack([axis.cut(g[n], like)
                                             for g in per_stage]))
                for n, like in enumerate(tree.leaves(stage_p))])
            del per_stage
            del synced_s
            ost = adam.AdamState(step=state["opt_step"], m=state["opt_m"],
                                 v=state["opt_v"])
            new_p, ost, opt_mets = adam.update(
                {"stage": stage_p, "shared": shared_p},
                {"stage": synced_stack, "shared": synced_sh}, ost, cfg.adam,
                gnorm=gnorm)
            # EF norm of each stage's live (own-schedule) state
            ef = {}
            for k, s in enumerate(hosted):
                prefix = f"p{splans.d_of_stage[s]}:"
                ef[s] = powersgd.ef_norm_sq(
                    {key: LowRankState(q=v.q[k], err=v.err[k])
                     for key, v in comp2.items()
                     if key.startswith(prefix)
                     and isinstance(v, LowRankState)}).to(device)
            ef_norm = torch.sqrt(pmean(pipe.psum_pipe(ef, zero)))
        new_state = {
            "stage_params": new_p["stage"],
            "shared_params": new_p["shared"],
            "opt_m": ost.m, "opt_v": ost.v, "opt_step": ost.step,
            "comp": comp2,
        }
        metrics = {"loss": loss, "entropy": entropy,
                   "stage_entropy": stage_entropy, "ef_norm": ef_norm,
                   **opt_mets}
        step.sync_launches = tuple(launches)
        return new_state, metrics

    step.sync_launches = ()
    return step
