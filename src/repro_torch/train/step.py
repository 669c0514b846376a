"""Flat data-parallel train step (port of the flat branch of ``repro/train/step.py``).

One step: loss and gradients on this worker's batch shard, the DP sync
through the :class:`SyncExecutor` (compressed factor means for planned
leaves, plain means for the rest), the GDS entropy of the synced
gradients when the alpha gate asks for it, and an AdamW update.
``cfg.num_stages > 1``, or a pipe transport, routes to the pipelined step
(``repro_torch.pipeline.executor``), which reads the embedded
``PipelineConfig``: schedule, microbatches, stash policy, and
``overlap_sync`` with ``chunk_bytes`` (the per-stage sync split into
chunks of at most that many bytes and launched in the drain ticks).

The fault channel: a batch may carry an ``_inject`` flag tensor (the
trainer adds it on every step once a ``nan_grad`` fault is scheduled);
where any element is > 0 the gradients become NaN before the sync,
selected on the device with no host sync. ``guard_nonfinite`` computes
the whole update and keeps the old state leaf-wise where the loss or the
synced gradients' norm is not finite, reporting ``metrics["skipped"]``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.core import powersgd
from repro_torch.core.compressor import CompressionPlan
from repro_torch.core.config import SYNC_FIELDS, alias_property, resolve_embedded
from repro_torch.core.entropy import GDSConfig, grads_entropy
from repro_torch.core.sync_executor import SyncExecutor
from repro_torch.dist.collectives import make_dp_pmean
from repro_torch.models.model import Model
from repro_torch.optim import adam
from repro_torch.pipeline.config import PIPELINE_FIELDS

__all__ = ["TrainStepConfig", "make_train_step"]


@dataclasses.dataclass(frozen=True, init=False)
class TrainStepConfig:
    """Config of ``make_train_step``; ``pipeline``/``sync`` are the embedded configs."""

    mode: str = "dp_tp"
    policy_plan: CompressionPlan = CompressionPlan(ranks=())
    gds: GDSConfig = GDSConfig()
    measure_entropy: bool = True
    remat: bool = True             # checkpoint the whole loss function
    guard_nonfinite: bool = False  # recovery: skip non-finite updates
    pipeline: object = None
    sync: object = None
    adam: adam.AdamConfig = dataclasses.field(default_factory=adam.AdamConfig)

    def __init__(self, mode: str = "dp_tp",
                 policy_plan: CompressionPlan = CompressionPlan(ranks=()),
                 gds: GDSConfig | None = None, measure_entropy: bool = True,
                 remat: bool = True, guard_nonfinite: bool = False,
                 pipeline=None, sync=None, adam=None, **legacy) -> None:
        pipeline, sync = resolve_embedded(pipeline, sync, legacy,
                                          where="TrainStepConfig")
        if adam is None:
            from repro_torch.optim.adam import AdamConfig
            adam = AdamConfig()
        set_ = lambda k, v: object.__setattr__(self, k, v)
        set_("mode", mode)
        set_("policy_plan", policy_plan)
        set_("gds", gds if gds is not None else GDSConfig())
        set_("measure_entropy", measure_entropy)
        set_("remat", remat)
        set_("guard_nonfinite", guard_nonfinite)
        set_("pipeline", pipeline)
        set_("sync", sync)
        set_("adam", adam)


for _name in PIPELINE_FIELDS:
    setattr(TrainStepConfig, _name, alias_property("pipeline", _name))
for _name in SYNC_FIELDS:
    setattr(TrainStepConfig, _name, alias_property("sync", _name))
del _name


def make_train_step(model: Model, cfg: TrainStepConfig, psum_mean=None,
                    pipe=None, donate: bool = False):
    """Returns ``step(state, batch) -> (state, metrics)``.

    state = {params, opt_m, opt_v, opt_step, comp}; metrics = {loss,
    entropy, ef_norm, lr, grad_norm} (and ``skipped`` under
    ``guard_nonfinite``), all 0-d tensors left on the device.
    ``comp`` holds one LowRankState per shape group and, under a coded
    wire, a raw fp32 ``ef:<path>`` residual per flat-bucket member; the
    sync returns both, and ``ef_norm`` counts the PowerSGD residuals only,
    as the reference does.
    ``psum_mean`` defaults to the mean over the ``torch.distributed`` world.

    ``donate`` (the flat step; the reference jits its step with
    ``donate_argnums=0``): the step writes the new EF residuals, parameters
    and moments into ``state``'s tensors as it computes them, so it never
    holds two copies of the state; the caller must not use the old state
    after the call. It refuses ``guard_nonfinite``, which keeps the old
    state where an update is refused.

    ``cfg.num_stages > 1`` or a ``pipe`` transport (``LocalPipe``,
    ``DistPipe``) returns the pipelined step instead, with the
    stage-partitioned state of ``pipeline.executor``.
    """
    if cfg.num_stages > 1 or pipe is not None:
        if donate:
            raise ValueError("donate applies to the flat step only")
        from repro_torch.pipeline.executor import make_pipeline_train_step
        return make_pipeline_train_step(model, cfg, psum_mean, pipe)
    if cfg.mode != "dp_tp":
        raise NotImplementedError(f"mode={cfg.mode!r}: only the flat dp_tp "
                                  "step is ported")
    if donate and cfg.guard_nonfinite:
        raise ValueError("donate conflicts with guard_nonfinite: the guard "
                         "keeps the old state where it refuses an update")
    pmean = psum_mean or make_dp_pmean()
    sync_exec = SyncExecutor(cfg.sync, mode="flat", plan=cfg.policy_plan,
                             donate=donate)
    loss_fn = model.loss_fn

    def step(state, batch):
        batch = dict(batch)
        inject = batch.pop("_inject", None)
        params = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                               state["params"])
        with torch.enable_grad():
            if cfg.remat:
                loss, mets = checkpoint(loss_fn, params, batch,
                                        use_reentrant=False)
            else:
                loss, mets = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, tree.leaves(params))
        if inject is not None:
            bad = torch.amax(inject) > 0
            grads = [g.masked_fill(bad, float("nan")) for g in grads]
        grads = tree.unflatten(params, grads)
        loss = pmean(loss.detach())
        comp_in = state["comp"]
        synced, comp = sync_exec.sync(grads, comp_in, pmean)
        del grads
        entropy = (grads_entropy(synced, cfg.gds) if cfg.measure_entropy
                   else torch.zeros((), device=loss.device))
        opt_state = adam.AdamState(state["opt_step"], state["opt_m"],
                                   state["opt_v"])
        skipped = None
        if cfg.guard_nonfinite:
            # A non-finite loss or synced-gradient norm (NaN injection, a
            # corrupted compressor payload, divergence) must reach neither
            # the optimizer nor the compressor's warm-start/EF state: the
            # whole update is computed, then the old state kept leaf-wise.
            gnorm = adam.global_norm(synced)
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            new_params, new_opt, opt_mets = adam.update(
                state["params"], synced, opt_state, cfg.adam, gnorm=gnorm)
            keep = lambda new, old: tree.tree_map(
                lambda a, b: torch.where(ok, a, b, out=a), new, old)
            new_params = keep(new_params, state["params"])
            opt_state = adam.AdamState(
                step=keep(new_opt.step, opt_state.step),
                m=keep(new_opt.m, opt_state.m), v=keep(new_opt.v, opt_state.v))
            comp = keep(comp, comp_in)
            skipped = 1.0 - ok.to(torch.float32)
        else:
            new_params, opt_state, opt_mets = adam.update(
                state["params"], synced, opt_state, cfg.adam, inplace=donate)
        ef_norm = torch.sqrt(pmean(powersgd.ef_norm_sq(comp).to(loss.device)))
        new_state = {"params": new_params, "opt_m": opt_state.m,
                     "opt_v": opt_state.v, "opt_step": opt_state.step,
                     "comp": comp}
        metrics = {"loss": loss, "entropy": entropy, "ef_norm": ef_norm,
                   **opt_mets,
                   **{k: pmean(v.detach()) for k, v in mets.items()
                      if k != "loss"}}
        if skipped is not None:
            metrics["skipped"] = skipped
        return new_state, metrics

    return step
