"""Trainer: the host loop that runs EDGC (or a baseline policy) end to end.

Port of the flat path of ``repro/train/trainer.py``:
  * builds model/optimizer/compressor state on an explicit device,
  * drives the EDGCController: alpha-gated entropy readings, window
    boundaries, plan changes (stacked compressor state re-laid out),
  * resolves the wire codec (``SyncConfig.wire``) and, in entropy mode,
    re-picks its bit width at window ends,
  * accounts the exact DP-sync wire bytes per step, coded and raw,
  * saves and restores checkpoints.

Data parallelism is one process per worker under ``torch.distributed``
(initialised by the caller): each worker takes its contiguous slice of the
global batch, as the reference's ``data`` mesh axis shards it. The
pipelined executor, faults/recovery and telemetry are later slices
(ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterator

import torch

from repro_torch import tree
from repro_torch.core import (EDGCConfig, EDGCController, classify_leaves,
                              init_compressor_state, plan_wire_bytes,
                              resize_compressor_state, wire)
from repro_torch.core.bucketing import make_bucket_layout
from repro_torch.core.config import SYNC_FIELDS, alias_property, resolve_embedded
from repro_torch.core.sync_executor import SyncExecutor
from repro_torch.core.powersgd import fold_in, resize_rank
from repro_torch.dist.collectives import (dp_all_gather, dp_barrier, dp_rank,
                                          dp_world_size)
from repro_torch.models.model import Model, param_count
from repro_torch.optim import adam
from repro_torch.pipeline.config import PIPELINE_FIELDS
from repro_torch.pipeline.sync import stage_wire_bytes
from repro_torch.train import checkpoint as ckpt_mod
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
    ckpt_every: int = 0             # 0 = no checkpoints
    ckpt_path: str = "ckpt/state"
    min_compress_dim: int = 64
    measure_entropy: bool = True
    remat: bool = False
    pipeline: Any = None
    sync: Any = None
    adam: adam.AdamConfig = dataclasses.field(default_factory=adam.AdamConfig)

    def __init__(self, total_steps: int = 1000, log_every: int = 50,
                 ckpt_every: int = 0, ckpt_path: str = "ckpt/state",
                 min_compress_dim: int = 64, measure_entropy: bool = True,
                 remat: bool = False, pipeline=None, sync=None, adam=None,
                 **legacy) -> None:
        pipeline, sync = resolve_embedded(pipeline, sync, legacy,
                                          where="TrainerConfig")
        self.total_steps = total_steps
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.ckpt_path = ckpt_path
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

        # Entropy mode re-picks the codec at window ends against the run's
        # first reading; until a reading exists it codes at quant8.
        self._wire_ref_entropy: float | None = None
        self._codec = SyncExecutor.resolve_codec(self.sync_cfg)
        self.sync_cfg = dataclasses.replace(self.sync_cfg, codec=self._codec)

        self._comp_seed = fold_in(seed, 123)
        ost = adam.init(params, tcfg.adam)
        self._layout = (make_bucket_layout(self.leaves, self.controller.plan,
                                           self.sync_cfg.bucket_bytes)
                        if self._bucketed else None)
        comp = init_compressor_state(params, self.controller.plan,
                                     fold_in(seed, 99), layout=self._layout,
                                     wire_ef=self._codec is not None)
        self.state = {"params": params, "opt_m": ost.m, "opt_v": ost.v,
                      "opt_step": ost.step, "comp": comp}

        self._step_cache: dict[Any, Any] = {}
        self.history: list[dict] = []
        self.bytes_synced = 0           # exact DP wire bytes so far (coded)
        self.bytes_wire_raw = 0         # the same payloads priced uncoded
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
        comp_bytes, raw_bytes, full_bytes = self._price_plan()
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
            self.bytes_wire_raw += raw_bytes
            self.bytes_full += full_bytes
            pending.append((step_idx, measure, mets, self.bytes_synced,
                            self.bytes_wire_raw, self.bytes_full, stage_b,
                            ctrl.dac.current_ranks() if not ctrl.in_warmup else [],
                            time.time() - t0))
            at_window = (step_idx + 1) % window == 0
            logged = (step_idx % tcfg.log_every == 0
                      or step_idx == tcfg.total_steps - 1)
            at_ckpt = bool(tcfg.ckpt_every
                           and (step_idx + 1) % tcfg.ckpt_every == 0)
            if at_window or logged or at_ckpt:
                # every gated reading of the window reaches the DAC first
                self._flush_pending(pending)
            if at_window:
                changed = ctrl.on_window_end(step_idx)
                if changed:
                    self._apply_plan_change()
                # entropy-mode coding re-picks its width on the same cadence
                if self._refresh_codec() or changed:
                    comp_bytes, raw_bytes, full_bytes = self._price_plan()
                    stage_b = self.stage_bytes()
            if at_ckpt:
                self.save_checkpoint(f"{tcfg.ckpt_path}_{step_idx + 1}",
                                     step=step_idx + 1)
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
        for (s_i, meas, _, b_syn, b_raw, b_full, st_b, ranks, wall), vals in zip(
                pending, host):
            vals = dict(zip(_METRIC_KEYS, vals))
            if meas:
                self._last_entropy = vals["entropy"]
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
                self.history.append(rec)
        pending.clear()

    # --------------------------------------------------------- checkpointing
    def _checkpoint_like(self, gather: bool) -> dict:
        """The state as the reference lays it out: each compressor leaf with
        a leading per-worker dim. ``gather`` collects every worker's leaves
        (a collective); otherwise the leaves are shape-only stand-ins."""
        lead = (dp_all_gather if gather else
                (lambda t: t[None].expand((self.world,) + tuple(t.shape))))
        return dict(self.state, comp=tree.tree_map(lead, self.state["comp"]))

    def save_checkpoint(self, path: str, step: int | None = None) -> None:
        """The device tree + the host control plane (controller/DAC/CQM).

        Every worker calls it (the compressor state is gathered); worker 0
        writes the pair. ``extra`` carries what the window loop mutates, so
        a resumed run continues mid-window instead of restarting warm-up.
        """
        state = self._checkpoint_like(gather=True)
        extra = {
            "step": int(step if step is not None else self._global_step),
            "bytes_synced": int(self.bytes_synced),
            "bytes_wire_raw": int(self.bytes_wire_raw),
            "bytes_full": int(self.bytes_full),
            "controller": self.controller.state_dict(),
        }
        if self.rank == 0:
            ckpt_mod.save(path, state, extra=extra)
        dp_barrier()

    def restore_checkpoint(self, path: str) -> int:
        """Restore the device tree + control plane; returns the global step.

        The controller state (and with it the plan) comes FIRST, the
        compressor state is re-shaped to that plan, and only then are the
        arrays loaded into it, onto this trainer's device. Entropy-mode
        coding re-derives its reference and bit width from the restored
        entropy history.
        """
        extra = ckpt_mod.read_extra(path)
        if "controller" in extra:
            self.controller.load_state_dict(extra["controller"])
            self._apply_plan_change()     # reshape comp state to the plan
        self.bytes_synced = int(extra.get("bytes_synced", 0))
        self.bytes_wire_raw = int(extra.get("bytes_wire_raw", 0))
        self.bytes_full = int(extra.get("bytes_full", 0))
        self._global_step = int(extra.get("step", 0))
        hist = self.controller.entropy_history
        self._last_entropy = float(hist[-1][1]) if hist else 0.0
        self._wire_ref_entropy = None
        self._refresh_codec()
        restored, _ = ckpt_mod.restore(path, self._checkpoint_like(gather=False))
        restored["comp"] = tree.tree_map(lambda t: t[self.rank].contiguous(),
                                         restored["comp"])
        self.state = restored
        return self._global_step

    # --------------------------------------------------------------- summary
    def stage_bytes(self) -> list[tuple[int, int]]:
        """Per-stage (compressed, full) DP-sync bytes under the current plan."""
        return stage_wire_bytes(self.leaves, self.controller.plan,
                                max(1, self.edgc_cfg.num_stages),
                                codec=self._codec)

    def comm_savings(self) -> float:
        """Fraction of DP-sync bytes saved vs no compression (Table III)."""
        if self.bytes_full == 0:
            return 0.0
        return 1.0 - self.bytes_synced / self.bytes_full
