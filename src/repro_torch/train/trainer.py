"""Trainer: the host loop that runs EDGC (or a baseline policy) end to end.

Port of the flat path of ``repro/train/trainer.py``:
  * builds model/optimizer/compressor state on an explicit device,
  * drives the EDGCController: alpha-gated entropy readings, window
    boundaries, plan changes (stacked compressor state re-laid out),
  * accounts the exact DP-sync wire bytes per step.

Data parallelism is one process per worker under ``torch.distributed``
(initialised by the caller): each worker takes its contiguous slice of the
global batch, as the reference's ``data`` mesh axis shards it. The
pipelined executor, checkpoints, faults/recovery and telemetry are later
slices (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterator

import torch

from repro_torch.core import (EDGCConfig, EDGCController, classify_leaves,
                              init_compressor_state, plan_wire_bytes,
                              resize_compressor_state)
from repro_torch.core.bucketing import make_bucket_layout
from repro_torch.core.config import SYNC_FIELDS, alias_property, resolve_embedded
from repro_torch.core.powersgd import fold_in, resize_rank
from repro_torch.dist.collectives import dp_rank, dp_world_size
from repro_torch.models.model import Model, param_count
from repro_torch.optim import adam
from repro_torch.pipeline.config import PIPELINE_FIELDS
from repro_torch.pipeline.sync import stage_wire_bytes
from repro_torch.train.step import TrainStepConfig, make_train_step

__all__ = ["TrainerConfig", "Trainer", "resolve_device"]

_METRIC_KEYS = ("loss", "entropy", "grad_norm", "lr")


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
    min_compress_dim: int = 64
    measure_entropy: bool = True
    remat: bool = False
    pipeline: Any = None
    sync: Any = None
    adam: adam.AdamConfig = dataclasses.field(default_factory=adam.AdamConfig)

    def __init__(self, total_steps: int = 1000, log_every: int = 50,
                 min_compress_dim: int = 64, measure_entropy: bool = True,
                 remat: bool = False, pipeline=None, sync=None, adam=None,
                 **legacy) -> None:
        pipeline, sync = resolve_embedded(pipeline, sync, legacy,
                                          where="TrainerConfig")
        self.total_steps = total_steps
        self.log_every = log_every
        self.min_compress_dim = min_compress_dim
        self.measure_entropy = measure_entropy
        self.remat = remat
        self.pipeline = pipeline
        self.sync = sync
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
                 tcfg: TrainerConfig, seed: int = 0, device=None) -> None:
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
        self.world = dp_world_size()
        self.rank = dp_rank()
        self.controller = EDGCController(edgc_cfg, self.leaves, world=self.world)

        # Only the flat executor is ported: the stage count the DAC sees
        # stays virtual, execution runs one stage.
        pcfg = tcfg.pipeline
        if pcfg.num_stages != 1:
            pcfg = dataclasses.replace(pcfg, num_stages=1)
        self.pipeline_cfg = pcfg
        self._bucketed = tcfg.sync.bucketed is not False
        self.sync_cfg = dataclasses.replace(tcfg.sync, bucketed=self._bucketed)

        self._comp_seed = fold_in(seed, 123)
        ost = adam.init(params, tcfg.adam)
        self._layout = (make_bucket_layout(self.leaves, self.controller.plan,
                                           self.sync_cfg.bucket_bytes)
                        if self._bucketed else None)
        comp = init_compressor_state(params, self.controller.plan,
                                     fold_in(seed, 99), layout=self._layout)
        self.state = {"params": params, "opt_m": ost.m, "opt_v": ost.v,
                      "opt_step": ost.step, "comp": comp}

        self._step_cache: dict[Any, Any] = {}
        self.history: list[dict] = []
        self.bytes_synced = 0           # exact DP wire bytes so far
        self.bytes_full = 0             # what no-compression would have moved
        self._last_entropy = 0.0        # most recent alpha-gated reading
        self._global_step = 0

    # ------------------------------------------------------------------ setup
    def _get_step(self, measure_entropy: bool):
        """Step function for the current plan and entropy gate."""
        plan = self.controller.plan
        key = (plan, measure_entropy, self.sync_cfg)
        if key not in self._step_cache:
            scfg = TrainStepConfig(
                mode="dp_tp", policy_plan=plan, gds=self.edgc_cfg.gds,
                measure_entropy=measure_entropy, remat=self.tcfg.remat,
                pipeline=self.pipeline_cfg, sync=self.sync_cfg,
                adam=self.tcfg.adam)
            self._step_cache[key] = make_train_step(self.model, scfg)
        return self._step_cache[key]

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

    def _apply_plan_change(self) -> None:
        """Resize/extend compressor state to the new plan."""
        plan = self.controller.plan
        comp = self.state["comp"]
        if self._bucketed:
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
        self.state = dict(self.state, comp=fresh)

    # ------------------------------------------------------------------- run
    def run(self, batches: Iterator[dict], num_steps: int | None = None
            ) -> list[dict]:
        """Run ``num_steps`` (default: remaining up to total_steps).

        Can be called repeatedly; the global step counter persists. Device
        metrics are read in one batch at flush points (log steps, window
        ends, run end), never inside the step loop.
        """
        tcfg, ctrl = self.tcfg, self.controller
        comp_bytes, full_bytes = plan_wire_bytes(self.leaves, ctrl.plan)
        stage_b = self.stage_bytes()
        window = self.edgc_cfg.dac.window
        t0 = time.time()
        start = self._global_step
        end = min(tcfg.total_steps, start + (num_steps if num_steps is not None
                                             else tcfg.total_steps - start))
        pending: list[tuple] = []
        for step_idx in range(start, end):
            batch = self._device_batch(next(batches))
            measure = tcfg.measure_entropy and ctrl.wants_entropy(step_idx)
            self.state, mets = self._get_step(measure)(self.state, batch)
            self.bytes_synced += comp_bytes
            self.bytes_full += full_bytes
            pending.append((step_idx, measure, mets, self.bytes_synced,
                            self.bytes_full, stage_b,
                            ctrl.dac.current_ranks() if not ctrl.in_warmup else [],
                            time.time() - t0))
            at_window = (step_idx + 1) % window == 0
            logged = (step_idx % tcfg.log_every == 0
                      or step_idx == tcfg.total_steps - 1)
            if at_window or logged:
                # every gated reading of the window reaches the DAC first
                self._flush_pending(pending)
            if at_window and ctrl.on_window_end(step_idx):
                self._apply_plan_change()
                comp_bytes, full_bytes = plan_wire_bytes(self.leaves, ctrl.plan)
                stage_b = self.stage_bytes()
        self._flush_pending(pending)
        self._global_step = end
        return self.history

    def _flush_pending(self, pending: list[tuple]) -> None:
        """One device->host copy of the buffered metrics, then in-order host
        processing (controller entropy feed, history records)."""
        if not pending:
            return
        host = torch.stack([torch.stack([m[k].detach().float().reshape(())
                                         for k in _METRIC_KEYS])
                            for _, _, m, *_ in pending]).cpu().tolist()
        for (s_i, meas, _, b_syn, b_full, st_b, ranks, wall), vals in zip(
                pending, host):
            vals = dict(zip(_METRIC_KEYS, vals))
            if meas:
                self._last_entropy = vals["entropy"]
                self.controller.on_entropy(s_i, self._last_entropy)
            if s_i % self.tcfg.log_every == 0 or s_i == self.tcfg.total_steps - 1:
                self.history.append({
                    "step": s_i, "loss": vals["loss"],
                    "entropy": self._last_entropy,   # zero-order hold
                    "grad_norm": vals["grad_norm"], "lr": vals["lr"],
                    "bytes_synced": b_syn, "bytes_full": b_full,
                    "stage_bytes": st_b, "ranks": ranks, "wall_s": wall,
                })
        pending.clear()

    # --------------------------------------------------------------- summary
    def stage_bytes(self) -> list[tuple[int, int]]:
        """Per-stage (compressed, full) DP-sync bytes under the current plan."""
        return stage_wire_bytes(self.leaves, self.controller.plan,
                                max(1, self.edgc_cfg.num_stages))

    def comm_savings(self) -> float:
        """Fraction of DP-sync bytes saved vs no compression (Table III)."""
        if self.bytes_full == 0:
            return 0.0
        return 1.0 - self.bytes_synced / self.bytes_full
