"""Elastic multi-pod outer-loop training (DiLoCo-style local SGD).

Port of ``repro/train/elastic.py``. One ``ElasticTrainer`` owns N pod-local
flat ``Trainer``s, each with its own data shard, plus an
``OuterOptimizer`` over the pod carrier (``launch.mesh.make_pod_mesh``).
Per outer round: every pod runs K inner steps from the shared anchor, the
anchor-minus-pod deltas all-reduce over the pods (EDGC-compressed, outer
DAC window), and a Nesterov outer update moves the anchor, which every pod
copies into its own buffers.

Elastic membership (pod drop/join between rounds) rebuilds the fleet
through a checkpoint round trip: the lead survivor's inner checkpoint
(params, optimizer, controller/DAC/CQM state, recovery counters) seeds
every rebuilt pod, and the outer optimizer migrates its per-pod EF rows
(survivors keep theirs, joiners get the shared warm-start Q and zero EF).

All pods run one after another in this process, as the reference runs them
over its local devices; ``devices`` lists where they may live (one card
repeated when they share it), and its length caps ``pod_join``. Pods as
processes across cards are ROADMAP Queue 1 item 10b.

Aliasing: the flat trainer updates its state in place (its step donates
the state unless the recovery guard is armed), so no two pods may share a
parameter tensor, and the anchor may share none with a pod: pod 0's step
would overwrite pod 1's start, and an anchor aliasing pod 0's params would
make every delta zero. Each pod copies the new anchor into its own
buffers, and the anchor is a tensor of its own.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Callable, Iterator

import torch

from repro_torch import tree
from repro_torch.launch.mesh import make_pod_mesh
from repro_torch.obs.metrics import JsonlSink, MetricsRegistry
from repro_torch.optim.outer import OuterConfig, OuterOptimizer
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.faults import FaultPlan
from repro_torch.train.trainer import Trainer, TrainerConfig, resolve_device

__all__ = ["ElasticTrainer"]

F32 = torch.float32


def _copy(params: Any) -> Any:
    return tree.tree_map(lambda a: a.detach().clone(), params)


class ElasticTrainer:
    """N inner Trainers + one OuterOptimizer + elastic membership.

    ``batch_fn(pod_index)`` yields a fresh batch iterator for a pod: pods
    train on different data shards (that is what the outer average buys).
    Inner-step fault injection (``tcfg.faults``) targets pod 0; the
    round-scheduled events (``pod_drop``/``pod_join``) are handled here.
    ``devices`` defaults to the current CUDA device once per initial pod.
    """

    def __init__(self, model, edgc_cfg, tcfg: TrainerConfig,
                 ocfg: OuterConfig, n_pods: int,
                 batch_fn: Callable[[int], Iterator[dict]],
                 seed: int = 0, devices=None) -> None:
        if ocfg.outer_k < 1:
            raise ValueError("outer_k must be >= 1")
        if devices is None:
            devices = [resolve_device(None)] * n_pods
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) < n_pods:
            raise ValueError(f"{n_pods} pods need {n_pods} devices, have "
                             f"{len(self.devices)}")
        self.model = model
        self.edgc_cfg = edgc_cfg
        self.tcfg = tcfg
        self.ocfg = ocfg
        self.seed = seed
        self.batch_fn = batch_fn
        self.faults = tcfg.faults if tcfg.faults is not None else FaultPlan()
        self._fired_round_faults: set[int] = set()
        self.round_index = 0
        self.history: list[dict] = []

        # ONE registry for the fleet; each pod trainer writes through a
        # pod-tagged view (a metrics_dir per pod would open one JSONL
        # appender per pod on the same file)
        if tcfg.metrics is not None:
            self.metrics = tcfg.metrics
        elif tcfg.metrics_dir:
            self.metrics = MetricsRegistry(
                [JsonlSink(os.path.join(tcfg.metrics_dir, "metrics.jsonl"))])
        else:
            self.metrics = MetricsRegistry()

        self.pods: list[Trainer] = []
        self._batches: list[Iterator[dict]] = []
        self._build_pods(n_pods)
        self.outer = OuterOptimizer(
            self.pods[0].state["params"], ocfg, self.pod_mesh,
            model.config.num_layers, seed=seed,
            use_kernels=bool(tcfg.sync.use_kernels), hw=edgc_cfg.hw)
        # all pods init from the same seed, so pod 0's params are the anchor
        self.anchor = _copy(self.pods[0].state["params"])

    # ------------------------------------------------------------------ pods
    @property
    def n_pods(self) -> int:
        return len(self.pods)

    def _pod_tcfg(self, pod: int) -> TrainerConfig:
        t = copy.copy(self.tcfg)
        t.ckpt_every = 0          # checkpoints are composed, at round level
        t.total_steps = max(t.total_steps,
                            self.ocfg.outer_k * self.ocfg.total_rounds)
        t.metrics = self.metrics.with_tags(pod=pod)
        t.metrics_dir = None
        if pod != 0:
            t.faults = None       # inner-step fault injection hits pod 0
        return t

    def _build_pods(self, n_pods: int) -> None:
        devices = self.devices[:n_pods]
        # drop the old fleet before building the new one: on one card the
        # old pods' state would otherwise sit beside the new pods'
        self.pods = []
        self._batches = []
        for p in range(n_pods):
            self.pods.append(Trainer(self.model, self.edgc_cfg,
                                     self._pod_tcfg(p), seed=self.seed,
                                     device=devices[p]))
            self._batches.append(self.batch_fn(p))
        self.pod_mesh = make_pod_mesh(n_pods, self.devices)

    @torch.no_grad()
    def _set_pod_params(self, params: Any) -> None:
        """Copy ``params`` into every pod's own parameter buffers."""
        for tr in self.pods:
            for dst, src in zip(tree.leaves(tr.state["params"]),
                                tree.leaves(params)):
                dst.copy_(src)

    # ------------------------------------------------------------ membership
    def resize(self, survivors: list[int], n_new: int,
               ckpt_base: str | None = None) -> None:
        """Membership change to ``n_new`` pods through a checkpoint round
        trip. ``survivors`` are OLD pod indices whose outer EF rows carry
        over (their order is the new pods' order); pods beyond them are
        joiners. The lead survivor's inner checkpoint seeds every rebuilt
        pod, so joiners resume mid-run instead of restarting warm-up."""
        if not survivors:
            raise ValueError("at least one pod must survive")
        if len(survivors) > n_new:
            raise ValueError(f"{len(survivors)} survivors > {n_new} pods")
        base = ckpt_base or f"{self.tcfg.ckpt_path}_elastic_r{self.round_index}"
        lead = self.pods[survivors[0]]
        lead.save_checkpoint(f"{base}_inner", step=lead._global_step)
        del lead
        self._build_pods(n_new)
        for tr in self.pods:
            tr.restore_checkpoint(f"{base}_inner")
        self.outer.resize_pods(self.pod_mesh, survivors)
        self.anchor = _copy(self.pods[0].state["params"])

    def _handle_round_faults(self) -> list[str]:
        applied = []
        for i, ev in enumerate(self.faults.events):
            if (not ev.on_round or ev.at != self.round_index
                    or i in self._fired_round_faults):
                continue
            self._fired_round_faults.add(i)
            if ev.kind == "pod_drop":
                if self.n_pods == 1:
                    continue      # never drop the last pod
                target = (ev.arg if 0 <= ev.arg < self.n_pods
                          else self.n_pods - 1)
                survivors = [p for p in range(self.n_pods) if p != target]
                self.resize(survivors, self.n_pods - 1)
                applied.append(f"pod_drop:{target}")
                self.metrics.event("pod_drop", round=self.round_index,
                                   target=int(target), n_pods=self.n_pods)
            elif ev.kind == "pod_join":
                if self.n_pods >= len(self.devices):
                    continue      # no device for the joiner
                self.resize(list(range(self.n_pods)), self.n_pods + 1)
                applied.append("pod_join")
                self.metrics.event("pod_join", round=self.round_index,
                                   n_pods=self.n_pods)
        return applied

    # ----------------------------------------------------------------- round
    def run_rounds(self, rounds: int) -> list[dict]:
        for _ in range(rounds):
            events = self._handle_round_faults()
            for p, tr in enumerate(self.pods):
                tr.run(self._batches[p], num_steps=self.ocfg.outer_k)
            with torch.no_grad():
                deltas = [tree.tree_map(lambda a, b: a.to(F32) - b.to(F32),
                                        self.anchor, tr.state["params"])
                          for tr in self.pods]
            new_params, info = self.outer.round(self.anchor, deltas)
            del deltas
            self._set_pod_params(new_params)
            self.anchor = new_params
            # a rebuilt pod with no logged step yet reports NaN, as the
            # reference's does (log_every > K leaves rounds without one)
            losses = [tr.history[-1]["loss"] if tr.history else float("nan")
                      for tr in self.pods]
            info.update({
                "n_pods": self.n_pods,
                "membership_events": events,
                "pod_losses": losses,
                "recovery": (self.pods[0].recovery.as_dict()
                             if self.pods[0].recovery is not None else None),
            })
            self.history.append(info)
            self.metrics.event(
                "outer_round", round=self.round_index,
                **{k: v for k, v in info.items()
                   if k != "round"
                   and isinstance(v, (int, float, str, bool, list, dict,
                                      type(None)))})
            self.metrics.flush()
            self.round_index += 1
        return self.history

    # --------------------------------------------------------- checkpointing
    def save_checkpoint(self, path: str) -> None:
        """Composed elastic checkpoint: the lead pod's inner state + the
        outer arrays and control plane. Valid at round boundaries only
        (pod params equal the anchor there)."""
        lead = self.pods[0]
        lead.save_checkpoint(f"{path}_inner", step=lead._global_step)
        ckpt_mod.save(f"{path}_outer", self.outer.arrays, extra={
            "outer": self.outer.state_dict(),
            "round": int(self.round_index),
            "n_pods": int(self.n_pods),
        })

    def restore_checkpoint(self, path: str) -> int:
        """Restore at the checkpoint's pod count (elastic resume): rebuild
        the fleet at the saved size, restore inner and outer state, and
        return the restored round index."""
        extra = ckpt_mod.read_extra(f"{path}_outer")
        n_saved = int(extra["n_pods"])
        if n_saved > len(self.devices):
            raise ValueError(f"the checkpoint holds {n_saved} pods, this "
                             f"fleet has {len(self.devices)} devices")
        if n_saved != self.n_pods:
            self._build_pods(n_saved)
        for tr in self.pods:
            tr.restore_checkpoint(f"{path}_inner")
        # the shared telemetry cursor restores once, at the fleet level
        # (the pods' restores write through tagged views and skip it)
        inner_extra = ckpt_mod.read_extra(f"{path}_inner")
        if "metrics" in inner_extra:
            self.metrics.load_state_dict(inner_extra["metrics"])
        self.outer.set_mesh(self.pod_mesh)
        self.outer.load_state_dict(extra["outer"],
                                   self.pods[0].state["params"])
        arrs, _ = ckpt_mod.restore(f"{path}_outer", self.outer.arrays)
        self.outer.load_arrays(arrs)
        self.anchor = _copy(self.pods[0].state["params"])
        self.round_index = int(extra["round"])
        return self.round_index
