"""Flat train step (port of the flat branch of ``repro/train/step.py``).

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

The two distribution modes of the reference, on a ``(data, model)``
process mesh (``launch.mesh.make_host_mesh``):

  * ``dp_tp`` (every config but three): each process computes the
    gradients of its batch rows; the parameters are DTensors on the
    mesh's ``model`` axis placed by ``dist.sharding``'s rules
    (``state_shardings``), the forward runs under DTensor's sharding
    propagation, and the DP sync is explicit over the data group:
    compressed factor means for planned leaves on their local shards
    (``core.compressor``), plain means for the rest.
  * ``auto`` (``SHARDING_MODE`` of llama3-405b, kimi-k2-1t-a32b and
    qwen3-moe-235b-a22b): the parameters and moments are DTensors on the
    whole mesh, FSDP over ``data`` (``apply_fsdp``) and TP over
    ``model``, the batch is split over ``data``, and the gradient reduce
    is DTensor's. No sync runs, so the plan must be ``none`` (the
    reference: "compression policy must be 'none' in this mode").

On a mesh with a ``pod`` axis (the dry run's multi-pod production mesh)
the DP mean runs over pod and data together (``launch.mesh.dp_group``).
``make_prefill_step`` and ``make_serve_step`` are the reference's serving
steps: the full-sequence forward and one decode token.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.core import powersgd
from repro_torch.core.compressor import CompressionPlan
from repro_torch.core.config import SYNC_FIELDS, alias_property, resolve_embedded
from repro_torch.core.entropy import GDSConfig, grads_entropy
from repro_torch.core.sync_executor import SyncExecutor
from repro_torch.dist import sharding, tp
from repro_torch.dist.sharding import contiguous_stride
from repro_torch.dist.collectives import make_dp_pmean
from repro_torch.launch.mesh import dp_group
from repro_torch.models.model import Model
from repro_torch.optim import adam
from repro_torch.pipeline.config import PIPELINE_FIELDS

__all__ = ["TrainStepConfig", "batch_shardings", "distribute_comp",
           "distribute_state", "full_state", "make_prefill_step",
           "make_serve_step", "make_train_step", "state_shardings"]


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
                    pipe=None, donate: bool = False, mesh=None):
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
    stage-partitioned state of ``pipeline.executor``; a ``mesh`` with a
    ``model`` axis runs it with its parameters placed on the model
    sub-mesh, and its DP mean defaults to the mesh's data group.

    ``mesh`` (a ``(data, model)`` mesh): the state's tensors are DTensors
    placed by ``distribute_state`` (on the ``model`` sub-mesh in
    ``dp_tp``; on the whole mesh with ``fsdp=True`` in ``auto``), and each
    process passes its own rows of the batch; the DP mean defaults to the
    mesh's data group. A mesh with a ``model`` axis runs
    the DTensor placements and the model-group collectives at model size
    1 too.
    """
    if cfg.num_stages > 1 or pipe is not None:
        if donate:
            raise ValueError("donate applies to the flat step only")
        from repro_torch.pipeline.executor import make_pipeline_train_step
        if psum_mean is None and mesh is not None:
            psum_mean = make_dp_pmean(dp_group(mesh))
        return make_pipeline_train_step(model, cfg, psum_mean, pipe,
                                        mesh=mesh)
    if cfg.mode not in ("dp_tp", "auto"):
        raise ValueError(f"unknown mode {cfg.mode!r} (want dp_tp or auto)")
    if cfg.mode == "auto":
        if mesh is None:
            raise ValueError("mode='auto' needs a (data, model) mesh")
        if cfg.policy_plan.ranks:
            raise NotImplementedError(
                "mode='auto' syncs through DTensor's gradient reduce: the "
                "compression policy must be 'none' in this mode")
    if donate and cfg.guard_nonfinite:
        raise ValueError("donate conflicts with guard_nonfinite: the guard "
                         "keeps the old state where it refuses an update")
    auto = cfg.mode == "auto"
    if auto:
        pmean = lambda x: x          # the loss is already the global mean
    else:
        pmean = psum_mean or make_dp_pmean(dp_group(mesh))
    sync_exec = SyncExecutor(cfg.sync, mode="flat", plan=cfg.policy_plan,
                             donate=donate)
    loss_fn = model.loss_fn
    on_mesh = mesh is not None

    def step(state, batch):
        batch = dict(batch)
        inject = batch.pop("_inject", None)
        if auto:
            batch = {k: _split_rows(v, mesh) for k, v in batch.items()}
        params = tree.tree_map(lambda p: p.detach().requires_grad_(True),
                               state["params"])
        with torch.enable_grad(), tp.model_context(on_mesh):
            if cfg.remat:
                loss, mets = checkpoint(loss_fn, params, batch,
                                        use_reentrant=False)
            else:
                loss, mets = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, tree.leaves(params))
        grads = [tp.normalize_grad(g, p)
                 for g, p in zip(grads, tree.leaves(params))]
        if inject is not None:
            bad = torch.amax(inject) > 0
            grads = [tp.rewrap(g, tp.local(g).masked_fill(bad, float("nan")))
                     for g in grads]
        grads = tree.unflatten(params, grads)
        mets = {k: v.full_tensor() if isinstance(v, DTensor) else v
                for k, v in mets.items()}
        loss = pmean(loss.detach())
        comp_in = state["comp"]
        if auto:
            synced, comp = grads, comp_in
        else:
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
                lambda a, b: tp.rewrap(a, torch.where(
                    ok, tp.local(a), tp.local(b), out=tp.local(a))), new, old)
            new_params = keep(new_params, state["params"])
            opt_state = adam.AdamState(
                step=keep(new_opt.step, opt_state.step),
                m=keep(new_opt.m, opt_state.m), v=keep(new_opt.v, opt_state.v))
            comp = keep(comp, comp_in)
            skipped = 1.0 - ok.to(torch.float32)
        else:
            new_params, opt_state, opt_mets = adam.update(
                state["params"], synced, opt_state, cfg.adam, inplace=donate)
        ef_norm = torch.sqrt(pmean(
            powersgd.ef_norm_sq(comp, device=loss.device).to(loss.device)))
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


def _split_rows(t, mesh):
    """This process's batch rows as a DTensor split over the mesh's data
    axes (and replicated over ``model``)."""
    pl = tuple(Shard(0) if n in ("pod", "data") else Replicate()
               for n in mesh.mesh_dim_names)
    n = 1
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in ("pod", "data"):
            n *= mesh.size(i)
    shape = torch.Size((t.shape[0] * n,) + tuple(t.shape[1:]))
    return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def state_shardings(state, mesh, fsdp: bool = False) -> dict:
    """The specs of a flat state (``repro/train/step.py:245-289``):
    parameters and their moments by the TP rules (plus FSDP over the
    ("pod", "data") axes with ``fsdp``), ``opt_step`` replicated; each
    compressor residual as its parameter, its Q replicated, and the
    group-keyed (bucketed) and ``ef:`` entries replicated. The port keeps
    one worker's compressor state per process, so no entry has the
    reference's leading replica dim."""
    pspec = sharding.param_specs(state["params"], mesh, fsdp=fsdp)
    by_path = dict(zip((p for p, _ in tree.flatten_with_path(state["params"])),
                       sharding.spec_leaves(pspec)))
    comp = {}
    for path, st in state["comp"].items():
        if isinstance(st, powersgd.LowRankState):
            comp[path] = powersgd.LowRankState(q=(), err=by_path.get(path, ()))
        else:
            comp[path] = ()
    return {"params": pspec, "opt_m": pspec, "opt_v": pspec,
            "opt_step": (), "comp": comp}


def distribute_state(state, mesh, fsdp: bool = False) -> dict:
    """A state of whole tensors (every process holds the same) placed on
    ``mesh`` by ``state_shardings``: in ``dp_tp`` the mesh is the
    ``model`` sub-mesh, in ``auto`` the whole ``(data, model)`` mesh.

    A pipelined state (``stage_params``) is placed as the reference's
    ``pipeline_state_shardings`` places it on the model axis: the stage
    stacks and their moments by ``sharding.stage_param_pspecs`` (the
    stage dim whole: a process holds its hosted stages), the shared tree
    by the TP rules, and the compressor state whole."""
    if "stage_params" in state:
        return _distribute_pipelined(state, mesh)
    specs = state_shardings(dict({"comp": {}}, **state), mesh, fsdp=fsdp)
    out = dict(state)
    for key in ("params", "opt_m", "opt_v"):
        if key in state:
            out[key] = sharding.distribute_tree(state[key], specs[key], mesh)
    if "comp" in state:
        out["comp"] = distribute_comp(state["comp"], state["params"], mesh,
                                      specs=specs)
    return out


def _distribute_pipelined(state, mesh) -> dict:
    place = lambda t, specs: sharding.distribute_tree(t, specs, mesh)
    stage = sharding.stage_param_pspecs(state["stage_params"], mesh)
    shared = sharding.param_pspecs(state["shared_params"], mesh)
    out = dict(state)
    out["stage_params"] = place(state["stage_params"], stage)
    out["shared_params"] = place(state["shared_params"], shared)
    for key in ("opt_m", "opt_v"):
        if key in state:
            out[key] = {"stage": place(state[key]["stage"], stage),
                        "shared": place(state[key]["shared"], shared)}
    return out


def distribute_comp(comp: dict, params, mesh, fsdp: bool = False,
                    specs=None) -> dict:
    """Whole compressor state placed by ``state_shardings`` (``params``
    may be placed already: only their shapes are read)."""
    specs = specs or state_shardings({"params": params, "comp": comp}, mesh,
                                     fsdp=fsdp)
    return {k: _place_entry(v, specs["comp"][k], mesh)
            for k, v in comp.items()}


def _place_entry(st, spec, mesh):
    if isinstance(st, powersgd.LowRankState):
        return powersgd.LowRankState(*(
            sharding.distribute(t, sharding.to_placements(s, mesh), mesh)
            for t, s in zip(st, spec)))
    return sharding.distribute(st, sharding.to_placements(spec, mesh), mesh)


def full_state(state) -> dict:
    """A placed state's whole tensors (collectives over each split)."""
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    return tree.tree_map(whole, state)


def batch_shardings(batch, mesh, batch_size: int) -> dict:
    """The spec of every batch entry: its batch dim over the data axes."""
    return {k: sharding.batch_pspec(v.ndim, mesh, batch_size)
            for k, v in batch.items()}


# ----------------------------------------------------------------- serving
def make_prefill_step(model: Model):
    """Full-sequence forward (inference prefill): (params, batch) -> logits."""
    def prefill(params, batch):
        with torch.no_grad():
            return model.forward(params, batch)
    return prefill


def make_serve_step(model: Model):
    """One decode step: (params, cache, tokens (B,)) -> (logits, cache); the
    cache passed in is consumed (``Model.decode_step``)."""
    def serve(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return serve
