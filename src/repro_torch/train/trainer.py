"""Trainer: the host loop that runs EDGC (or a baseline policy) end to end.

Port of the flat path of ``repro/train/trainer.py``:
  * builds model/optimizer/compressor state on an explicit device,
  * drives the EDGCController: alpha-gated entropy readings, window
    boundaries, plan changes (stacked compressor state re-laid out),
  * resolves the wire codec (``SyncConfig.wire``) and, in entropy mode,
    re-picks its bit width at window ends,
  * accounts the exact DP-sync wire bytes per step, coded and raw,
  * emits structured telemetry (``repro_torch.obs.MetricsRegistry``),
  * injects scheduled faults and runs the recovery policy (non-finite
    guard + EF reset, rollback through a checkpoint ring, uncompressed
    fallback),
  * saves and restores checkpoints.

Data parallelism is one process per worker under ``torch.distributed``
(initialised by the caller): each worker takes its contiguous slice of the
global batch, as the reference's ``data`` mesh axis shards it.

``pipe=S`` is the counterpart of the reference's mesh with a ``pipe`` axis:
the state is partitioned into S stages (``pipeline.partition``) and each
step runs the pipelined executor, each stage synced at its own rank.
Without a ``mesh`` all S stage programs run in this process
(``pipeline.executor.LocalPipe``), with DP over the default group. With a
``(pipe, data)`` mesh (``launch.mesh.make_host_mesh``) each process hosts
one stage (``pipeline.executor.DistPipe`` over its pipe group) and holds
that stage's slices of the state, with DP over its data group; a
checkpoint gathers the reference's whole layout. Without ``pipe``,
``num_stages`` > 1 stays virtual: the DAC emits per-stage ranks and the
flat step runs.

A ``pod`` axis outermost (``make_host_mesh(pod=P, ...)``) makes each pod a
data-parallel island: the DP group is pod x data, flattened pod-major
(``launch.mesh.dp_group``), so the world, this worker's batch slice, the
compressor replicas a checkpoint gathers and the one a restore takes
follow worker p * data + w, as the reference counts its DP world over
("pod", "data"); with a pipe axis each stage's group is its own.

A ``(data, model)`` mesh (``launch.mesh.make_host_mesh(data=D, model=M)``)
runs the ``dp_tp`` step with tensor parallelism: the state's tensors are
DTensors on the mesh's ``model`` axis placed by the reference's rules
(``train.step.state_shardings``), every process of a DP worker's model
group reads that worker's batch rows, and the sync is the per-leaf one on
the local shards unless the model axis is 1 (``bucketing_supported``). A
coded wire needs the bucketed sync, so it is refused above model size 1.
Checkpoints hold whole tensors, gathered over the model group, and a
restore places them on this trainer's mesh, whatever model size wrote
them. Beside ``pipe`` the mesh may carry a model axis too: ``(pipe, data,
model)``, one stage a process, or ``(data, model)`` with every stage in
this process; the stage and shared trees and their moments are placed by
``sharding.stage_param_pspecs`` and the TP rules (the reference's
``pipeline_state_shardings``), and the compressor state stays whole.

``overlap_sync`` (pipelined runs) launches each stage's sync chunks in the
drain ticks ``pipeline.schedule.plan_overlap`` assigns and feeds the plan's
Eq. 4 slack to the DAC, which aligns and clamps the stage ranks against it.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Iterator

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.core import (EDGCConfig, EDGCController, classify_leaves,
                              init_compressor_state, plan_wire_bytes,
                              resize_compressor_state, wire)
from repro_torch.core.bucketing import bucketing_supported, make_bucket_layout
from repro_torch.core.config import SYNC_FIELDS, alias_property, resolve_embedded
from repro_torch.core.sync_executor import SyncExecutor
from repro_torch.core.powersgd import fold_in, resize_rank
from repro_torch.dist import tp
from repro_torch.dist.collectives import (dp_all_gather, dp_barrier, dp_rank,
                                          dp_world_size, make_dp_pmean)
from repro_torch.launch.mesh import dp_group, pipe_size
from repro_torch.models.model import Model, param_count
from repro_torch.obs.metrics import JsonlSink, MetricsRegistry, fetch
from repro_torch.obs.trace import span
from repro_torch.optim import adam
from repro_torch.pipeline import sync as psync
from repro_torch.pipeline.config import PIPELINE_FIELDS
from repro_torch.pipeline.schedule import plan_overlap
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.faults import (FaultPlan, RecoveryState,
                                      poison_lowrank_state, truncate_file)
from repro_torch.train.step import (TrainStepConfig, distribute_comp,
                                    distribute_state, full_state,
                                    make_train_step)

__all__ = ["TrainerConfig", "Trainer", "resolve_device"]

# the step metrics a flush reads (``skipped`` only under the guard,
# ``stage_entropy`` only on the pipelined step, ``aux``, the MoE router's
# load-balance loss, only on the flat step of the MoE family)
_METRIC_KEYS = ("loss", "entropy", "grad_norm", "lr", "ef_norm", "skipped",
                "stage_entropy", "aux")


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA unless the caller names another.

    Never falls back: with no device given and no CUDA, it raises.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass(init=False)
class TrainerConfig:
    """Host-loop config; ``pipeline``/``sync`` are the embedded configs.

    ``sync.bucketed=None`` resolves to the bucketed executor.
    """

    total_steps: int = 1000
    log_every: int = 50
    ckpt_every: int = 0             # 0 = no checkpoints
    ckpt_path: str = "ckpt/state"
    min_compress_dim: int = 64
    measure_entropy: bool = True
    remat: bool = False
    recovery: Any = None            # train.faults.RecoveryConfig
    faults: Any = None              # train.faults.FaultPlan (injection)
    pipeline: Any = None
    sync: Any = None
    metrics: Any = None             # obs.MetricsRegistry (or a tagged view)
    metrics_dir: str | None = None  # JSONL sink at <dir>/metrics.jsonl
    adam: adam.AdamConfig = dataclasses.field(default_factory=adam.AdamConfig)

    def __init__(self, total_steps: int = 1000, log_every: int = 50,
                 ckpt_every: int = 0, ckpt_path: str = "ckpt/state",
                 min_compress_dim: int = 64, measure_entropy: bool = True,
                 remat: bool = False, recovery=None, faults=None,
                 pipeline=None, sync=None, metrics=None, metrics_dir=None,
                 adam=None, **legacy) -> None:
        pipeline, sync = resolve_embedded(pipeline, sync, legacy,
                                          where="TrainerConfig")
        self.total_steps = total_steps
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.ckpt_path = ckpt_path
        self.min_compress_dim = min_compress_dim
        self.measure_entropy = measure_entropy
        self.remat = remat
        self.recovery = recovery
        self.faults = faults
        self.pipeline = pipeline
        self.sync = sync
        self.metrics = metrics
        self.metrics_dir = metrics_dir
        if adam is None:
            from repro_torch.optim.adam import AdamConfig
            adam = AdamConfig()
        self.adam = adam


for _name in PIPELINE_FIELDS:
    setattr(TrainerConfig, _name, alias_property("pipeline", _name,
                                                 settable=True))
for _name in SYNC_FIELDS:
    setattr(TrainerConfig, _name, alias_property("sync", _name, settable=True))
del _name


class Trainer:
    def __init__(self, model: Model, edgc_cfg: EDGCConfig,
                 tcfg: TrainerConfig, seed: int = 0, device=None,
                 pipe: int | None = None, mesh=None) -> None:
        self.device = resolve_device(device)
        self.model = model
        self.edgc_cfg = edgc_cfg
        self.tcfg = tcfg
        if edgc_cfg.policy == "edgc" and not tcfg.measure_entropy:
            raise ValueError("policy='edgc' requires measure_entropy=True: "
                             "the DAC consumes the GDS entropy readings")

        params = model.init(seed, self.device)
        self.n_params = param_count(params)
        self.leaves = classify_leaves(params, model.config.num_layers,
                                      edgc_cfg.num_stages,
                                      min_dim=tcfg.min_compress_dim)
        # a mesh with a pipe axis hosts one stage per process: DP runs over
        # the stage's pod x data group (pod-major), the pipe collectives
        # over the pipe group
        self._dp_group = dp_group(mesh)
        # a mesh with a model axis: the dp_tp step with tensor parallelism
        self._mesh = None
        if mesh is not None and "model" in mesh.mesh_dim_names:
            self._mesh = mesh
        self._pipe_group = None
        if mesh is not None and "pipe" in mesh.mesh_dim_names:
            if pipe_size(mesh) != pipe:
                raise ValueError(f"mesh pipe axis size {pipe_size(mesh)} != "
                                 f"pipe={pipe}")
            self._pipe_group = mesh.get_group("pipe")
        self.world = dp_world_size(self._dp_group)
        self.rank = dp_rank(self._dp_group)
        self._writer = dp_rank() == 0      # the process that writes files
        self.controller = EDGCController(edgc_cfg, self.leaves, world=self.world)

        # pipe=S runs S stages; without it the stage count the DAC sees
        # stays virtual and execution runs one stage
        self.pipelined = pipe is not None
        if self.pipelined and pipe != edgc_cfg.num_stages:
            raise ValueError(f"pipe={pipe} != num_stages="
                             f"{edgc_cfg.num_stages}")
        pcfg = tcfg.pipeline
        s_exec = edgc_cfg.num_stages if self.pipelined else 1
        if pcfg.num_stages != s_exec:
            pcfg = dataclasses.replace(pcfg, num_stages=s_exec)
        self.pipeline_cfg = pcfg
        # the pipelined sync is always the per-stage bucketed executor; the
        # flat one is bucketed only where the mesh supports it (model 1)
        self._bucketed = (tcfg.sync.bucketed is not False
                          and bucketing_supported(self._mesh))
        self.sync_cfg = dataclasses.replace(
            tcfg.sync, bucketed=None if self.pipelined else self._bucketed)
        if (self.sync_cfg.wire != "raw" and not self.pipelined
                and not self._bucketed):
            raise ValueError(
                f"wire={self.sync_cfg.wire!r} requires the bucketed sync "
                "executor (unsupported mesh or SyncConfig.bucketed=False)")

        # Entropy mode re-picks the codec at window ends against the run's
        # first reading; until a reading exists it codes at quant8.
        self._wire_ref_entropy: float | None = None
        self._codec = SyncExecutor.resolve_codec(self.sync_cfg)
        self.sync_cfg = dataclasses.replace(self.sync_cfg, codec=self._codec)

        self._comp_seed = fold_in(seed, 123)
        self._transport = None
        if self.pipelined:
            self._init_pipelined_state(params, fold_in(seed, 99), tcfg.adam)
        else:
            ost = adam.init(params, tcfg.adam)
            self._layout = (make_bucket_layout(self.leaves,
                                               self.controller.plan,
                                               self.sync_cfg.bucket_bytes)
                            if self._bucketed else None)
            comp = init_compressor_state(params, self.controller.plan,
                                         fold_in(seed, 99),
                                         layout=self._layout,
                                         wire_ef=self._codec is not None)
            self.state = {"params": params, "opt_m": ost.m, "opt_v": ost.v,
                          "opt_step": ost.step, "comp": comp}
            if self._mesh is not None:
                self.state = distribute_state(self.state, self._mesh["model"])

        # overlapped per-stage sync: the DAC gets the schedule's Eq. 4
        # slack, so Algorithm 2 aligns (and clamps) ranks against the
        # geometry the overlap planner schedules
        self.overlap_plan = None
        if self.pipelined and pcfg.overlap_sync:
            S = pcfg.num_stages
            self.overlap_plan = plan_overlap(
                pcfg.schedule, S, pcfg.num_microbatches or S, self._splans)
            t_mb = self.controller.dac.t_micro_back
            self.controller.set_overlap_feedback(
                [t * t_mb for t in self.overlap_plan.slack_seconds])

        self._step_cache: dict[Any, Any] = {}
        self.step_configs: dict[Any, TrainStepConfig] = {}
        self.history: list[dict] = []
        self.bytes_synced = 0           # exact DP wire bytes so far (coded)
        self.bytes_wire_raw = 0         # the same payloads priced uncoded
        self.bytes_full = 0             # what no-compression would have moved
        self._last_entropy = 0.0        # most recent alpha-gated reading
        self._last_stage_entropy = None  # per-stage hold (pipelined only)
        self._global_step = 0

        # ----- telemetry: tcfg.metrics wins (a shared registry or a tagged
        # view); else metrics_dir attaches a JSONL sink; else a registry
        # with no sink, so the loop never needs a null check
        if tcfg.metrics is not None:
            self.metrics = tcfg.metrics
        elif tcfg.metrics_dir and self._writer:
            self.metrics = MetricsRegistry(
                [JsonlSink(os.path.join(tcfg.metrics_dir, "metrics.jsonl"))])
        else:
            self.metrics = MetricsRegistry()
        self.metrics.event(
            "run_meta", step=0,
            model=model.config.name, family=model.config.family,
            policy=edgc_cfg.policy, n_params=int(self.n_params),
            world=self.world, pipelined=self.pipelined,
            num_stages=int(edgc_cfg.num_stages), schedule=pcfg.schedule,
            num_microbatches=int(pcfg.num_microbatches or pcfg.num_stages),
            stash_policy=pcfg.stash_policy, overlap_sync=pcfg.overlap_sync,
            window=int(edgc_cfg.dac.window), log_every=int(tcfg.log_every),
            total_steps=int(tcfg.total_steps))
        if self.overlap_plan is not None:
            op = self.overlap_plan
            n_in = [sum(len(ids) for _, ids in op.launches[s])
                    for s in range(op.num_stages)]
            n_res = [len(op.residual[s]) for s in range(op.num_stages)]
            total = sum(n_in) + sum(n_res)
            self.metrics.event(
                "overlap_plan", step=0,
                in_loop=n_in, residual=n_res,
                slack_seconds=list(op.slack_seconds),
                est_sync_seconds=list(op.est_sync_seconds),
                feasible=list(op.feasible),
                slack_utilization=(sum(n_in) / total if total else 0.0))

        # ----- fault injection and the recovery policy
        self.faults = tcfg.faults if tcfg.faults is not None else FaultPlan()
        self.recovery = (RecoveryState() if tcfg.recovery is not None
                         else None)
        self._guard = bool(tcfg.recovery is not None
                           and tcfg.recovery.guard_nonfinite
                           and not self.pipelined)
        if self.pipelined and (self.faults.has("nan_grad")
                               or self.faults.has("corrupt_payload")):
            raise ValueError("nan_grad/corrupt_payload fault injection "
                             "requires the flat (non-pipelined) trainer: "
                             "the pipelined step has no guard/injection "
                             "channel yet")
        self._ckpt_ring: list[tuple[str, int]] = []  # newest last
        self._tear_next_ckpt = False                 # torn_ckpt fault armed
        self._last_step_ok = True                    # recovered-event edge
        self._ema_seen = 0                           # spike-detector warmup
        # Faults are one-shot (transient): a rollback that replays past a
        # fired event's step must not re-inject it, or a deterministic
        # fault would defeat every retry.
        self._fired_faults: set[int] = set()

    def _init_pipelined_state(self, params, comp_seed: int, acfg) -> None:
        """The stage-partitioned state: the family's adapter owns the
        layout (stacked stage keys, ragged padding, leaf paths)."""
        from repro_torch.pipeline import partition as ppart
        from repro_torch.pipeline.executor import DistPipe, LocalPipe, host_state
        S = self.edgc_cfg.num_stages
        reason = ppart.pipeline_supported(self.model.config, S)
        if reason is not None:
            raise ValueError(f"pipeline trainer unsupported: {reason}")
        self._part = ppart.make_partition(self.model, S,
                                          remat=self.tcfg.remat)
        self._transport = (LocalPipe(S) if self._pipe_group is None
                           else DistPipe(S, group=self._pipe_group))
        stage_p, shared_p = self._part.partition_params(params)
        ost = adam.init({"stage": stage_p, "shared": shared_p}, acfg)
        self._splans = self._stage_plans(stage_p)
        comp = psync.init_pipeline_comp_state(
            params, self.controller.plan, comp_seed, self._splans,
            wire_ef=self._codec is not None, device=self.device)
        self.state = {
            "stage_params": stage_p, "shared_params": shared_p,
            "opt_m": ost.m, "opt_v": ost.v, "opt_step": ost.step,
            "comp": comp,
        }
        if self._pipe_group is not None:
            self.state = host_state(self.state, self._transport.stages)
        if self._mesh is not None:
            self.state = distribute_state(self.state, self._mesh["model"])

    def _stage_plans(self, stage_p):
        return psync.make_stage_plans(
            self.controller.plan, self.edgc_cfg.num_stages,
            psync.stage_local_leaves(stage_p),
            bucket_bytes=self.sync_cfg.bucket_bytes,
            chunk_bytes=self.pipeline_cfg.chunk_bytes,
            local_path=self._part.local_leaf_path)

    # ------------------------------------------------------------------ setup
    def _get_step(self, measure_entropy: bool):
        """Step function for the current plan and entropy gate."""
        plan = self.controller.plan
        key = (plan, measure_entropy, self.sync_cfg)
        if key not in self._step_cache:
            scfg = TrainStepConfig(
                mode="dp_tp", policy_plan=plan, gds=self.edgc_cfg.gds,
                measure_entropy=measure_entropy, remat=self.tcfg.remat,
                guard_nonfinite=self._guard, pipeline=self.pipeline_cfg,
                sync=self.sync_cfg, adam=self.tcfg.adam)
            self.step_configs[key] = scfg
            # the flat step updates the state in place, as the reference's
            # jit donates it, unless the guard must keep the old state
            self._step_cache[key] = make_train_step(
                self.model, scfg, psum_mean=make_dp_pmean(self._dp_group),
                pipe=self._transport,
                donate=not (self.pipelined or self._guard), mesh=self._mesh)
        return self._step_cache[key]

    def step_cache_keys(self) -> tuple:
        """Every ``(plan, measure_entropy, sync_cfg)`` key a step variant
        was built for: the auditor's recompile pass proves the count stays
        window-bounded (plans and codecs change only at DAC windows)."""
        return tuple(self._step_cache)

    def _device_batch(self, batch: dict) -> dict:
        """This worker's contiguous slice of the global batch, on device."""
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v)
            if v.shape[0] % self.world:
                raise ValueError(f"global batch {v.shape[0]} does not split "
                                 f"over {self.world} workers")
            per = v.shape[0] // self.world
            v = v[self.rank * per:(self.rank + 1) * per]
            if not v.is_floating_point():
                v = v.long()
            out[k] = v.to(self.device)
        return out

    def _refresh_codec(self) -> bool:
        """Entropy-mode wire coding: re-pick the bit width from the latest
        pooled entropy reading against the run's first one. Returns True
        when the codec changed (the ledger must re-price). Called at window
        ends only, so a new step variant comes with the plan cadence."""
        if self.sync_cfg.wire != "entropy":
            return False
        hist = self.controller.entropy_history
        if not hist:
            return False
        if self._wire_ref_entropy is None:
            self._wire_ref_entropy = float(hist[0][1])
        new = wire.resolve_codec("entropy", entropy_nats=self._last_entropy,
                                 ref_nats=self._wire_ref_entropy)
        if new == self._codec:
            return False
        self._codec = new
        self.sync_cfg = dataclasses.replace(self.sync_cfg, codec=new)
        return True

    def _price_plan(self) -> tuple[int, int, int]:
        """(coded, raw-payload, no-compression) bytes per step under the
        current plan; coded == raw when wire coding is off."""
        plan = self.controller.plan
        comp, full = plan_wire_bytes(self.leaves, plan, codec=self._codec)
        raw = (plan_wire_bytes(self.leaves, plan)[0]
               if self._codec is not None else comp)
        return comp, raw, full

    def _apply_plan_change(self) -> None:
        """Resize/extend compressor state to the new plan."""
        plan = self.controller.plan
        comp = full_state(self.state["comp"])
        if self.pipelined:
            # the resize reads every stage's slices: a process that hosts
            # one stage gathers them and keeps its own
            new_splans = self._stage_plans(self.state["stage_params"])
            fresh = psync.resize_pipeline_comp_state(
                tree.tree_map(self._gather_stages, comp), self._splans,
                new_splans, self._comp_seed, device=self.device)
            fresh = tree.tree_map(self._own_stages, fresh)
            self._splans = new_splans
        elif self._bucketed:
            new_layout = make_bucket_layout(self.leaves, plan,
                                            self.sync_cfg.bucket_bytes)
            fresh = resize_compressor_state(
                comp, plan, self._comp_seed, old_layout=self._layout,
                new_layout=new_layout, device=self.device)
            self._layout = new_layout
        else:
            fresh = init_compressor_state(self.state["params"], plan,
                                          self._comp_seed)
            for path in list(fresh):
                if path in comp:
                    fresh[path] = resize_rank(comp[path], plan.rank_of(path),
                                              self._comp_seed)
        self.state = dict(self.state, comp=self._place_comp(fresh))

    # ------------------------------------------------------------------- run
    def run(self, batches: Iterator[dict], num_steps: int | None = None
            ) -> list[dict]:
        """Run ``num_steps`` (default: remaining up to total_steps).

        Can be called repeatedly; the global step counter persists. Device
        metrics are read in one batched copy at flush points (log steps,
        window ends, checkpoints, run end), never inside the step loop,
        with one documented exception: with ``tcfg.recovery`` set, the
        host reads each step's loss (and guard flag) to decide. A guarded
        skip (non-finite update) triggers an EF reset, a non-finite or
        spiking loss rolls back to the newest intact checkpoint in the ring
        (bounded retries and a re-arm backoff), and repeated anomalies pin
        the controller to uncompressed sync.
        """
        tcfg, ctrl = self.tcfg, self.controller
        rcfg, rs = tcfg.recovery, self.recovery
        comp_bytes, raw_bytes, full_bytes = self._price_plan()
        stage_b = self.stage_bytes()
        window = self.edgc_cfg.dac.window
        t0 = time.time()
        start = self._global_step
        end = min(tcfg.total_steps, start + (num_steps if num_steps is not None
                                             else tcfg.total_steps - start))
        inject_nan_faults = self.faults.has("nan_grad")
        pending: list[tuple] = []
        step_idx = start
        while step_idx < end:
            measure = tcfg.measure_entropy and ctrl.wants_entropy(step_idx)
            with span("trainer.step", step=step_idx, gated=bool(measure)):
                with span("trainer.batch"):
                    batch = self._device_batch(next(batches))
                fired_now = [(i, ev) for i, ev in enumerate(self.faults.events)
                             if not ev.on_round and ev.at == step_idx
                             and i not in self._fired_faults]
                self._fired_faults.update(i for i, _ in fired_now)
                for _, ev in fired_now:
                    self.metrics.event("fault_injected", step=step_idx,
                                       kind=ev.kind, at=int(ev.at))
                    if ev.kind == "corrupt_payload":
                        self._poison_comp_state()
                    elif ev.kind == "torn_ckpt":
                        self._tear_next_ckpt = True
                if inject_nan_faults:
                    # one batch structure for every step once any nan_grad is
                    # scheduled: the flag is zero except at the fault's step
                    flag = float(any(ev.kind == "nan_grad"
                                     for _, ev in fired_now))
                    bsz = next(iter(batch.values())).shape[0]
                    batch["_inject"] = torch.full((bsz,), flag,
                                                  device=self.device)
                self.state, mets = self._get_step(measure)(self.state, batch)
                self.bytes_synced += comp_bytes
                self.bytes_wire_raw += raw_bytes
                self.bytes_full += full_bytes

                step_ok = True
                if rs is not None:
                    loss, skipped = self._read_step(mets)
                    if skipped:
                        # The guard refused the update; the compressor's warm
                        # start and EF may still hold the garbage that caused
                        # it (a corrupted payload), so reset them.
                        rs.skipped_steps += 1
                        rs.anomalies += 1
                        self.metrics.event("guard_skip", step=step_idx,
                                           loss=loss)
                        self._reset_comp_state()
                        rs.ef_resets += 1
                        self.metrics.counter("ef_resets", step=step_idx)
                        self.metrics.event("ef_reset", step=step_idx)
                        step_ok = False
                    elif not math.isfinite(loss):
                        rs.anomalies += 1
                        step_ok = False
                        rolled = self._maybe_rollback()
                        if rolled is not None:
                            self.metrics.event("rollback", step=step_idx,
                                               restored_step=int(rolled))
                            self._maybe_fallback(ctrl)
                            comp_bytes, raw_bytes, full_bytes = \
                                self._price_plan()
                            stage_b = self.stage_bytes()
                            step_idx = rolled
                            continue
                    else:
                        armed = (self._ema_seen >= rcfg.spike_warmup
                                 and step_idx >= rs.backoff_until)
                        if (armed and rs.loss_ema is not None and rcfg.rollback
                                and loss > rcfg.spike_factor
                                * max(rs.loss_ema, 1e-8)):
                            rs.anomalies += 1
                            rolled = self._maybe_rollback()
                            if rolled is not None:
                                self.metrics.event("rollback", step=step_idx,
                                                   restored_step=int(rolled),
                                                   spike_loss=loss)
                                self._maybe_fallback(ctrl)
                                comp_bytes, raw_bytes, full_bytes = \
                                    self._price_plan()
                                stage_b = self.stage_bytes()
                                step_idx = rolled
                                continue
                        rs.loss_ema = (loss if rs.loss_ema is None else
                                       rcfg.ema_decay * rs.loss_ema
                                       + (1 - rcfg.ema_decay) * loss)
                        self._ema_seen += 1
                    if self._maybe_fallback(ctrl):
                        comp_bytes, raw_bytes, full_bytes = \
                            self._price_plan()
                        stage_b = self.stage_bytes()
                    if step_ok and not self._last_step_ok:
                        self.metrics.event("recovered", step=step_idx)
                    self._last_step_ok = step_ok

                # a step the guard refused feeds no entropy to the DAC
                pending.append((step_idx, measure and step_ok, mets,
                                self.bytes_synced, self.bytes_wire_raw,
                                self.bytes_full, stage_b,
                                (ctrl.dac.current_ranks()
                                 if not ctrl.in_warmup else []),
                                rs.as_dict() if rs is not None else None,
                                time.time() - t0))
                at_window = (step_idx + 1) % window == 0
                logged = (step_idx % tcfg.log_every == 0
                          or step_idx == tcfg.total_steps - 1)
                at_ckpt = bool(tcfg.ckpt_every
                               and (step_idx + 1) % tcfg.ckpt_every == 0)
                if at_window or logged or at_ckpt:
                    # every gated reading of the window reaches the DAC first
                    with span("trainer.flush"):
                        self._flush_pending(pending)
                if at_window:
                    with span("trainer.replan"):
                        changed = ctrl.on_window_end(step_idx)
                        if changed:
                            self._apply_plan_change()
                            self.metrics.event("plan_change", step=step_idx,
                                               ranks=ctrl.dac.current_ranks())
                        # entropy-mode coding re-picks its width on the
                        # same cadence
                        if self._refresh_codec():
                            changed = True
                            self.metrics.event("wire_codec", step=step_idx,
                                               bits=int(self._codec.bits),
                                               entropy=self._last_entropy)
                        if changed:
                            comp_bytes, raw_bytes, full_bytes = \
                                self._price_plan()
                            stage_b = self.stage_bytes()
                if at_ckpt:
                    with span("trainer.checkpoint"):
                        path = f"{tcfg.ckpt_path}_{step_idx + 1}"
                        self.save_checkpoint(path, step=step_idx + 1)
                        self.metrics.event("checkpoint", step=step_idx,
                                           path=path)
                        if self._tear_next_ckpt:
                            # torn_ckpt fault: a crash mid-write, simulated
                            # after the (atomic) save by truncating the
                            # archive in place
                            if self._writer:
                                truncate_file(path + ".npz")
                            dp_barrier()
                            self._tear_next_ckpt = False
                        self._ring_push(path, step_idx + 1)
                step_idx += 1
        with span("trainer.flush"):
            self._flush_pending(pending)
        self._global_step = end
        return self.history

    def _read_step(self, mets: dict) -> tuple[float, bool]:
        """The step's loss and guard verdict, in one device-to-host copy
        (the recovery policy's per-step read)."""
        if "skipped" not in mets:
            return fetch([mets["loss"]])[0], False
        loss, skipped = fetch([mets["loss"], mets["skipped"]])
        return loss, skipped > 0.5

    def _flush_pending(self, pending: list[tuple]) -> None:
        """One device->host copy of the buffered metrics, then in-order host
        processing (controller entropy feed, history records, telemetry)
        and a registry flush."""
        names = [[k for k in _METRIC_KEYS if k in m] for _, _, m, *_ in pending]
        host = iter(fetch([m[k] for (_, _, m, *_), ks in zip(pending, names)
                           for k in ks]))
        for (s_i, meas, _, b_syn, b_raw, b_full, st_b, ranks, rec_rs,
             wall), ks in zip(pending, names):
            vals = {k: next(host) for k in ks}
            if meas:
                self._last_entropy = vals["entropy"]
                if "stage_entropy" in vals:
                    self._last_stage_entropy = list(vals["stage_entropy"])
                self.controller.on_entropy(s_i, self._last_entropy)
            if s_i % self.tcfg.log_every == 0 or s_i == self.tcfg.total_steps - 1:
                rec = {
                    "step": s_i, "loss": vals["loss"],
                    "entropy": self._last_entropy,   # zero-order hold
                    "grad_norm": vals["grad_norm"], "lr": vals["lr"],
                    "bytes_synced": b_syn, "bytes_full": b_full,
                    "stage_bytes": st_b, "ranks": ranks, "wall_s": wall,
                }
                if b_raw != b_syn:      # wire coding is on
                    rec["bytes_wire_raw"] = b_raw
                if "aux" in vals:
                    rec["aux"] = vals["aux"]
                if rec_rs is not None:
                    rec["recovery"] = rec_rs
                self.history.append(rec)
                self._emit_step_telemetry(s_i, vals, b_syn, b_raw, b_full,
                                          st_b, ranks, wall)
        pending.clear()
        self.metrics.flush()

    def _emit_step_telemetry(self, s_i: int, vals: dict, b_syn: int,
                             b_raw: int, b_full: int, st_b, ranks,
                             wall: float) -> None:
        """One logged step's structured records (values already on host)."""
        reg = self.metrics
        reg.scalar("loss", vals["loss"], s_i)
        reg.scalar("entropy", self._last_entropy, s_i)
        reg.scalar("grad_norm", vals["grad_norm"], s_i)
        reg.scalar("lr", vals["lr"], s_i)
        reg.scalar("ef_norm", vals["ef_norm"], s_i)
        reg.scalar("bytes_synced", int(b_syn), s_i)
        reg.scalar("bytes_full", int(b_full), s_i)
        if b_syn:
            reg.scalar("compression_ratio", b_full / b_syn, s_i)
        if self.sync_cfg.wire != "raw":
            # coded vs raw payload bytes: the measured wire-format
            # reduction, orthogonal to the rank-compression ratio above
            reg.scalar("wire_bytes_coded", int(b_syn), s_i)
            reg.scalar("wire_bytes_raw", int(b_raw), s_i)
            if b_raw:
                reg.scalar("wire_reduction", b_syn / b_raw, s_i)
            if self._codec is not None:
                reg.scalar("wire_bits", int(self._codec.bits), s_i)
        reg.scalar("wall_s", wall, s_i)
        reg.series("stage_wire_bytes", [int(c) for c, _ in st_b], s_i)
        reg.series("stage_wire_bytes_full", [int(f) for _, f in st_b], s_i)
        if ranks:
            reg.series("dac_applied_ranks", [int(r) for r in ranks], s_i)
            cqm = self.controller.cqm
            if cqm.anchored:
                reg.series("cqm_error",
                           [float(cqm.error_at(int(r))) for r in ranks], s_i)
        if self._last_stage_entropy is not None:
            # the same zero-order hold as the pooled reading
            reg.series("stage_entropy", list(self._last_stage_entropy), s_i)

    # ------------------------------------------------------------- recovery
    def _ring_push(self, path: str, step: int) -> None:
        keep = (self.tcfg.recovery.ckpt_ring
                if self.tcfg.recovery is not None else 3)
        self._ckpt_ring.append((path, step))
        del self._ckpt_ring[:-keep]

    def _maybe_rollback(self) -> int | None:
        """Try the ring newest-to-oldest; returns the restored step or None.

        A torn newest checkpoint (``CheckpointError``) falls through to the
        next older one: the atomic save and its nonce make this safe.
        """
        rcfg, rs = self.tcfg.recovery, self.recovery
        if not (rcfg.rollback and rs.rollbacks < rcfg.max_rollbacks):
            return None
        while self._ckpt_ring:
            path, _ = self._ckpt_ring[-1]
            try:
                restored = self.restore_checkpoint(path, load_recovery=False)
            except ckpt_mod.CheckpointError:
                self._ckpt_ring.pop()
                continue
            rs.rollbacks += 1
            rs.backoff_until = restored + rcfg.backoff_steps
            rs.loss_ema = None          # re-warm the spike detector
            self._ema_seen = 0
            return restored
        return None

    def _maybe_fallback(self, ctrl) -> bool:
        """After ``fallback_after`` anomalies, pin to uncompressed sync."""
        rcfg, rs = self.tcfg.recovery, self.recovery
        if rs.fallback or rs.anomalies < rcfg.fallback_after:
            return False
        rs.fallback = True
        if ctrl.force_fallback():
            self._apply_plan_change()
            return True
        return False

    def _reset_comp_state(self) -> None:
        """Fresh compressor state under the current plan (EF reset), on
        this trainer's device, with the coded wire's ``ef:`` residuals.

        Wholesale re-init rather than surgical repair: after a corrupted
        payload no row can be trusted, and the warm-start Q must be
        identical across workers anyway (the seed is).
        """
        if self.pipelined:
            raise RuntimeError("EF reset requires the flat trainer")
        fresh = init_compressor_state(self.state["params"],
                                      self.controller.plan, self._comp_seed,
                                      layout=self._layout,
                                      wire_ef=self._codec is not None)
        self.state = dict(self.state, comp=self._place_comp(fresh))

    def _poison_comp_state(self) -> None:
        """corrupt_payload fault: NaN-poison the compressor state in place
        (each process's shard: the first leaf is a replicated Q or ``ef:``
        residual, so every process poisons the same element)."""
        poison_lowrank_state(tree.tree_map(tp.local, self.state["comp"]))

    # ------------------------------------------------- tensor parallelism
    def _place_comp(self, comp: dict) -> dict:
        """Whole compressor state placed as the live state's is (the
        pipelined state keeps it whole)."""
        if self._mesh is None or self.pipelined:
            return comp
        return distribute_comp(comp, self.state["params"], self._mesh["model"])

    # --------------------------------------------------------- checkpointing
    def _gather_stages(self, t: torch.Tensor) -> torch.Tensor:
        """A stage-stacked leaf with every stage's slice: gathered over the
        pipe group where each process hosts one stage (a collective)."""
        if self._pipe_group is None:
            return t
        return dp_all_gather(t[0], self._pipe_group)

    def _own_stages(self, t: torch.Tensor) -> torch.Tensor:
        """The hosted stages' slices of a stage-stacked leaf."""
        if self._pipe_group is None:
            return t
        s = self._transport.stage
        return t[s:s + 1].contiguous()

    def _checkpoint_like(self, gather: bool) -> dict:
        """The state as the reference lays it out: each compressor leaf with
        a per-worker dim, leading (flat) or after the stage dim (pipelined:
        (S, W, ...)), and every stage's slices. ``gather`` collects every
        process's leaves (collectives); otherwise the leaves are shape-only
        stand-ins."""
        state, comp = self.state, self.state["comp"]
        if self._mesh is not None:
            # whole tensors: gathered over the model group, or stand-ins
            # of their shapes that hold no memory
            whole = (full_state if gather else lambda t: tree.tree_map(
                lambda a: (torch.empty((), dtype=a.dtype, device=self.device)
                           .expand(a.shape) if isinstance(a, DTensor) else a),
                t))
            state = whole(state)
            comp = state["comp"]
        if self.pipelined:
            S = self.edgc_cfg.num_stages
            stages = (self._gather_stages if gather else
                      (lambda t: t[:1].expand((S,) + tuple(t.shape[1:]))))
            if self._pipe_group is not None:
                per = lambda t: tree.tree_map(stages, t)
                state = dict(
                    state, stage_params=per(state["stage_params"]),
                    opt_m=dict(state["opt_m"], stage=per(state["opt_m"]["stage"])),
                    opt_v=dict(state["opt_v"], stage=per(state["opt_v"]["stage"])))
                comp = per(comp)
            comp = (tree.tree_map(
                lambda t: dp_all_gather(t, self._dp_group).movedim(0, 1), comp)
                if gather else
                psync.replicate_pipeline_comp_state(comp, self.world))
        else:
            lead = ((lambda t: dp_all_gather(t, self._dp_group)) if gather else
                    (lambda t: t[None].expand((self.world,)
                                              + tuple(t.shape))))
            comp = tree.tree_map(lead, comp)
        return dict(state, comp=comp)

    def save_checkpoint(self, path: str, step: int | None = None) -> None:
        """The device tree + the host control plane (controller/DAC/CQM).

        Every process calls it (the state is gathered); rank 0 of the
        default group writes the pair. ``extra`` carries what the window loop mutates, so
        a resumed run continues mid-window instead of restarting warm-up.
        """
        state = self._checkpoint_like(gather=True)
        extra = {
            "step": int(step if step is not None else self._global_step),
            "bytes_synced": int(self.bytes_synced),
            "bytes_wire_raw": int(self.bytes_wire_raw),
            "bytes_full": int(self.bytes_full),
            "controller": self.controller.state_dict(),
            "metrics": self.metrics.state_dict(),
        }
        if self.recovery is not None:
            extra["recovery"] = self.recovery.as_dict()
        if self._writer:
            ckpt_mod.save(path, state, extra=extra)
        dp_barrier()

    def restore_checkpoint(self, path: str, load_recovery: bool = True) -> int:
        """Restore the device tree + control plane; returns the global step.

        The controller state (and with it the plan) comes FIRST, the
        compressor state is re-shaped to that plan, and only then are the
        arrays loaded into it, onto this trainer's device. Entropy-mode
        coding re-derives its reference and bit width from the restored
        entropy history.

        ``load_recovery=False`` (an in-run rollback) keeps the live recovery
        counters, which must not rewind their own retry budget, and the
        live telemetry cursor: what was emitted is history, not state.
        """
        extra = ckpt_mod.read_extra(path)
        if "controller" in extra:
            self.controller.load_state_dict(extra["controller"])
            self._apply_plan_change()     # reshape comp state to the plan
        if load_recovery and self.recovery is not None and "recovery" in extra:
            self.recovery = RecoveryState.from_dict(extra["recovery"])
        if (load_recovery and "metrics" in extra
                and isinstance(self.metrics, MetricsRegistry)):
            # a resumed run appends to its series instead of restarting at
            # step 0; a tagged view leaves the cursor to its owner
            self.metrics.load_state_dict(extra["metrics"])
        self.bytes_synced = int(extra.get("bytes_synced", 0))
        self.bytes_wire_raw = int(extra.get("bytes_wire_raw", 0))
        self.bytes_full = int(extra.get("bytes_full", 0))
        self._global_step = int(extra.get("step", 0))
        hist = self.controller.entropy_history
        self._last_entropy = float(hist[-1][1]) if hist else 0.0
        self._wire_ref_entropy = None
        self._refresh_codec()
        restored, _ = ckpt_mod.restore(path, self._checkpoint_like(gather=False))
        mine = ((lambda t: t[:, self.rank].contiguous()) if self.pipelined
                else (lambda t: t[self.rank].contiguous()))
        restored["comp"] = tree.tree_map(mine, restored["comp"])
        if self._pipe_group is not None:
            own = lambda t: tree.tree_map(self._own_stages, t)
            restored = dict(
                restored, stage_params=own(restored["stage_params"]),
                comp=own(restored["comp"]),
                opt_m=dict(restored["opt_m"], stage=own(restored["opt_m"]["stage"])),
                opt_v=dict(restored["opt_v"], stage=own(restored["opt_v"]["stage"])))
        if self._mesh is not None:
            restored = distribute_state(restored, self._mesh["model"])
        self.state = restored
        return self._global_step

    # --------------------------------------------------------------- summary
    def stage_bytes(self) -> list[tuple[int, int]]:
        """Per-stage (compressed, full) DP-sync bytes under the current plan."""
        return psync.stage_wire_bytes(self.leaves, self.controller.plan,
                                max(1, self.edgc_cfg.num_stages),
                                codec=self._codec)

    def comm_savings(self) -> float:
        """Fraction of DP-sync bytes saved vs no compression (Table III)."""
        if self.bytes_full == 0:
            return 0.0
        return 1.0 - self.bytes_synced / self.bytes_full
