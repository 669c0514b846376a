"""Dry run: one step of every (arch x input shape x mesh) on fake tensors.

Port of ``repro/launch/dryrun.py``. It shows that a distribution layout
is coherent without the hardware, at the published widths, and reads the
per-rank roofline terms: FLOPs, HBM bytes, collective bytes by kind and
across pods, and memory.

The reference lowers and compiles each combination on 512 fake host
devices and reads the compiled HLO. Here "lowering" runs the step once,
as rank 0 of a fake process group of the mesh's world
(``torch.testing._internal.distributed.fake_pg``, no communication):

  * the state is built by ``model.init`` under ``FakeTensorMode`` (shapes
    without memory) and placed as the trainer places it
    (``train.step.distribute_state``);
  * one train step, prefill or decode runs on this rank's batch rows under
    ``launch.op_cost.OpCounter``, which counts the FLOPs, the eager bytes,
    the collective bytes (the DP mean is an all-reduce over the fake
    data group, or pod x data) and the peak of live storage.

Differences from the reference, each a ROADMAP deviation:

  * pipelined runs (``--pipe``) are MPMD, as the port's pipeline is: each
    stage runs on its own ranks, so every stage runs once as its lead rank
    (the fake group made again per stage) and the record lists each
    stage's numbers under ``stages``; its top-level numbers are the stage
    with the most FLOPs. The reference runs SPMD, every stage masked on
    every rank;
  * ``bytes_per_chip`` is unfused eager traffic (``op_cost``), larger
    than the reference's fusion-boundary count;
  * the outer sync's pods live in one process (ROADMAP item 10b), so its
    cross-pod collective bytes are null; its FLOPs are one pod's share;
  * ``xla_cost_analysis`` and ``memory.code_bytes`` have no counterpart
    and are null;
  * the compressor state has no per-worker dim (each rank keeps its own);
  * the dry run counts the plain PowerSGD path (``SyncConfig.use_kernels``
    False, the reference's default): the same work whatever runs it, and
    the kernels' wrappers need real tensors.

``--device`` is ``cuda`` by default: fake CUDA tensors, the card's
dispatch, which needs a CUDA build of torch (a fake CUDA tensor's backward
aborts a CPU-only build); ``--device cpu`` runs anywhere.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch qwen2-0.5b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun          # everything
  ... --multi-pod | --pipe 4 | --outer-k 2 --multi-pod | --out results.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import tree
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config, sharding_mode
from repro_torch.core.bucketing import bucketing_supported, make_bucket_layout
from repro_torch.core.compressor import (NO_COMPRESSION, classify_leaves,
                                         init_compressor_state, make_plan,
                                         plan_wire_bytes)
from repro_torch.core.config import SyncConfig
from repro_torch.dist import sharding, tp
from repro_torch.dist.collectives import make_dp_pmean
from repro_torch.launch.mesh import (dp_group, make_production_mesh,
                                     production_sizes)
from repro_torch.launch.op_cost import OpCounter, storage_bytes
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.optim import adam
from repro_torch.train.step import (TrainStepConfig, _split_rows,
                                    distribute_state, make_prefill_step,
                                    make_serve_step, make_train_step)

__all__ = ["TensorSpec", "fake_world", "input_specs", "lower_one", "main",
           "record_summary", "stage_inputs", "train_inputs"]

POD_SIZE = 256          # ranks a pod: the reference's pod_size for cross-pod


class TensorSpec(NamedTuple):
    """Shape and dtype of one batch entry (``jax.ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


# ------------------------------------------------------------- input specs
def input_specs(cfg: ModelConfig, shape_name: str | dict
                ) -> dict[str, TensorSpec]:
    """Global shapes and dtypes of the batch of one input shape (a name of
    ``INPUT_SHAPES`` or an entry like theirs), the reference's: int32
    tokens (the step takes them as int64, as the trainer hands them over),
    the stub frames and patches in the config's dtype."""
    spec = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
            else shape_name)
    B, T = spec["global_batch"], spec["seq_len"]
    kind = spec["kind"]
    if kind in ("train", "prefill"):
        batch = {"tokens": TensorSpec((B, T), torch.int32)}
        if kind == "train":
            batch["labels"] = TensorSpec((B, T), torch.int32)
        if cfg.family == "whisper":
            batch["frames"] = TensorSpec((B, cfg.audio_frames, cfg.d_model),
                                         cfg.torch_dtype)
        if cfg.family == "vlm":
            batch["patches"] = TensorSpec((B, cfg.num_patches, cfg.d_model),
                                          cfg.torch_dtype)
        return batch
    # decode: ONE new token against a seq_len-deep cache
    return {"tokens": TensorSpec((B,), torch.int32)}


def _local_batch(specs: dict[str, TensorSpec], rows: int, device) -> dict:
    """This rank's batch rows as (fake) tensors, integers as int64."""
    out = {}
    for k, sp in specs.items():
        dt = sp.dtype if sp.dtype.is_floating_point else torch.long
        out[k] = torch.zeros((rows,) + tuple(sp.shape[1:]), dtype=dt,
                             device=device)
    return out


def _local_rows(batch_size: int, mesh) -> int:
    """Rows of the global batch this rank holds: the batch is split over
    the longest ("pod", "data") prefix that divides it (``batch_pspec``)."""
    entry = sharding._batch_entry(batch_size, mesh)
    if entry is None:
        return batch_size
    names = (entry,) if isinstance(entry, str) else entry
    sizes = sharding.axis_sizes(mesh)
    return batch_size // math.prod(sizes[a] for a in names)


# --------------------------------------------------------------- the world
@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A fake default process group of ``world`` ranks, this process being
    ``rank``, destroyed on every exit path. Refuses to start over a
    default group that exists already (the fake one would replace it)."""
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake default process "
                           "group, and one exists already")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        with _host_shard_offsets():
            yield
    finally:
        dist.destroy_process_group()
        _clear_sharding_caches()


@contextlib.contextmanager
def _host_shard_offsets():
    """DTensor reads a shard's size and offsets back as host integers from
    index tensors it makes (``_utils._compute_local_shape_and_global_offset``,
    which ``entropy.split_sample`` reaches, and the strided shard of a
    split dim merged with another); under ``FakeTensorMode`` those tensors
    would be fake and unreadable, so they are made outside the fake mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _utils, placement_types
    strided = getattr(placement_types, "_StridedShard", None)
    targets = [(owner, name, getattr(owner, name)) for owner, name in (
        (_utils, "_compute_local_shape_and_global_offset"),
        (strided, "local_shard_size_and_offset"))
        if getattr(owner, name, None) is not None]

    def on_host(fn):
        def run(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return run

    for owner, name, fn in targets:
        setattr(owner, name, on_host(fn))
    try:
        yield
    finally:
        for owner, name, fn in targets:
            setattr(owner, name, fn)


def _clear_sharding_caches() -> None:
    """DTensor caches its sharding propagation by a mesh's layout and
    names, so a mesh of the next fake world would be handed the last
    world's mesh, whose groups are gone."""
    prop = DTensor._op_dispatcher.sharding_propagator
    for fn in (prop.propagate_op_sharding, prop._propagate_tensor_meta_cached):
        fn.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if native is not None:          # the C++ dispatch's own cache
        native()


def _check_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the dry run's default device is cuda (fake CUDA tensors), "
            "which needs a CUDA build of torch and a card; this torch has "
            "none: pass --device cpu")
    return dev


def _build_mesh(device: torch.device, sizes: dict[str, int],
                production: bool):
    """The production mesh over the fake world, or a small one of
    ``sizes``."""
    if production:
        return make_production_mesh(multi_pod="pod" in sizes,
                                    pipe=sizes.get("pipe", 0),
                                    device_type=device.type)
    return init_device_mesh(device.type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


# ------------------------------------------------------------- one combo
def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              pipe: int = 0, policy: str = "edgc", rank: int = 64,
              opt_dtype: str = "float32", stash: str = "replay",
              stash_every: int = 2, overlap: bool = False,
              chunk_bytes: int = 0, outer_k: int = 0, outer_rank: int = 32,
              inject: bool = False, device: str = "cuda",
              mesh_shape: dict[str, int] | None = None,
              cfg: ModelConfig | None = None,
              spec: dict | None = None) -> dict:
    """Run one (arch, shape, mesh) on fake tensors; return the roofline
    record. The mesh is the production mesh (``multi_pod``, ``pipe``), or
    ``mesh_shape`` ({axis: size}, outer first) for a small one; ``cfg``
    and ``spec`` replace the arch's config and the input shape's entry
    (reduced runs)."""
    spec = dict(spec or INPUT_SHAPES[shape_name])
    kind = spec["kind"]
    mode = sharding_mode(arch)
    variant = "long" if shape_name == "long_500k" else "full"
    if cfg is None:
        cfg = get_config(arch, variant)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long_500k inapplicable (see DESIGN §5)"}
    S = pipe if pipe and pipe > 1 else (mesh_shape or {}).get("pipe", 0)
    if S and kind != "train":
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "pipeline mesh applies to train shapes only"}
    if S:
        from repro_torch.pipeline.partition import pipeline_supported
        cfg = dataclasses.replace(cfg, num_stages=S)
        reason = pipeline_supported(cfg, S)
        if reason is not None:
            return {"arch": arch, "shape": shape_name, "skipped": True,
                    "reason": f"pipeline: {reason}"}
    dev = _check_device(device)
    sizes = (dict(mesh_shape) if mesh_shape is not None else
             production_sizes(multi_pod=multi_pod, pipe=pipe))
    world = math.prod(sizes.values())
    model = build_model(cfg)
    t0 = time.time()
    if kind == "train" and S:   # every stage in a process of its own
        rec = _lower_train_pipelined(cfg, sizes, spec, policy, rank,
                                     opt_dtype, device, stash=stash,
                                     stash_every=stash_every, overlap=overlap,
                                     chunk_bytes=chunk_bytes,
                                     production=mesh_shape is None)
    else:
        with fake_world(world):
            mesh = _build_mesh(dev, sizes, mesh_shape is None)
            if kind == "train":
                rec = _lower_train(cfg, model, mesh, mode, spec, policy, rank,
                                   opt_dtype, dev, inject=inject)
            elif kind == "prefill":
                rec = _lower_prefill(cfg, model, mesh, mode, spec, dev)
            else:
                rec = _lower_decode(cfg, model, mesh, mode, spec, dev)
    pods = sizes.get("pod", 0)
    if outer_k and kind == "train":
        if pods:
            rec["outer_sync"] = _lower_outer_sync(cfg, model, pods,
                                                  outer_rank, dev)
            rec["outer_sync"]["outer_k"] = outer_k
        else:
            rec["outer_sync"] = {"skipped": True,
                                 "reason": "outer loop needs --multi-pod"}
    rec.update({"arch": arch, "shape": shape_name, "mode": mode,
                "mesh": "x".join(map(str, sizes.values())),
                "compile_s": round(time.time() - t0, 1)})
    return rec


def _record(counter: OpCounter, *, argument_bytes: int, output_bytes: int,
            alias_bytes: int) -> dict:
    """The roofline record of one counted run (``_record`` of the
    reference, ``dryrun.py:178-205``)."""
    walked = counter.result()
    coll = {k: int(v) for k, v in walked["collective_bytes"].items()}
    cross = {k: int(v) for k, v in walked["collective_bytes_cross"].items()}
    return {
        "flops_per_chip": float(walked["flops"]),
        "bytes_per_chip": float(walked["bytes"]),
        "collective_bytes_per_chip": coll,
        "collective_total": int(sum(coll.values())),
        "collective_cross_pod": cross,
        "collective_cross_total": int(sum(cross.values())),
        # XLA's own unscaled cost analysis: no counterpart in eager torch
        "xla_cost_analysis": None,
        "memory": {
            "argument_bytes": int(argument_bytes),
            "output_bytes": int(output_bytes),
            "temp_bytes": int(max(0, counter.peak_bytes - argument_bytes)),
            "alias_bytes": int(alias_bytes),
            # generated code size: an eager program has none to report
            "code_bytes": None,
        },
    }


def _count(fn, args, pod_size: int, donated: Any = None):
    """Run ``fn(*args)`` under a fresh counter (inside the caller's fake
    mode); returns (counter, output, argument bytes, output bytes,
    donated bytes)."""
    counter = OpCounter(pod_size=pod_size)
    arg_bytes = counter.track(args)
    alias = storage_bytes(donated) if donated is not None else 0
    with counter:
        out = fn(*args)
    return counter, out, arg_bytes, storage_bytes(out), alias


def _pod_size(mesh) -> int:
    return POD_SIZE if "pod" in mesh.mesh_dim_names else 0


def _train_plan(cfg, params, mode, policy, rank, num_stages):
    if mode == "auto":
        return None, NO_COMPRESSION
    leaves = classify_leaves(params, cfg.num_layers, num_stages, min_dim=128)
    plan = make_plan(policy, leaves, stage_ranks=[rank] * num_stages,
                     fixed_rank=rank, num_stages=num_stages)
    return leaves, plan


def train_inputs(cfg, model, mesh, mode, spec, policy, rank, *,
                 opt_dtype="float32", device="cpu", inject=False,
                 tensors=None, seed: int = 0):
    """The flat train step the dry run counts, with its arguments:
    (step, state, batch, plan, donated). ``tensors`` is the context the
    state and batch are made under (the dry run's ``FakeTensorMode``;
    none for a real step); the step and its process groups are made
    outside it. ``dp_tp`` runs the planned compressed sync (bucketed by the
    trainer's rule) and donates the state, as the trainer's step does;
    ``auto`` is FSDP + TP with no compression; ``inject`` adds the
    ``_inject`` batch field and the non-finite guard."""
    B = spec["global_batch"]
    auto = mode == "auto"
    acfg = adam.AdamConfig(opt_dtype=opt_dtype)
    # the trainer's executor rule, so the counts model what it runs
    bucketed = not auto and bucketing_supported(mesh)
    sync = SyncConfig(bucketed=bucketed or None)
    donate = not (auto or inject)
    pmean = make_dp_pmean(dp_group(mesh))
    with tensors or contextlib.nullcontext():
        params = model.init(seed, device)
        leaves, plan = _train_plan(cfg, params, mode, policy, rank,
                                   cfg.num_stages)
        ost = adam.init(params, acfg)
        layout = (make_bucket_layout(leaves, plan, sync.bucket_bytes)
                  if bucketed else None)
        comp = init_compressor_state(params, plan, 1, layout=layout)
        state = {"params": params, "opt_m": ost.m, "opt_v": ost.v,
                 "opt_step": ost.step, "comp": comp}
        state = (distribute_state(state, mesh, fsdp=True) if auto
                 else distribute_state(state, mesh["model"]))
        batch = _local_batch(input_specs(cfg, spec), _local_rows(B, mesh),
                             device)
        if inject:
            # the fault channel rides in the batch (train/faults.py)
            batch["_inject"] = torch.zeros((batch["tokens"].shape[0],),
                                           dtype=torch.float32, device=device)
    scfg = TrainStepConfig(mode=mode, policy_plan=plan,
                           measure_entropy=not auto, remat=cfg.remat,
                           adam=acfg, sync=sync, guard_nonfinite=inject)
    step = make_train_step(model, scfg, psum_mean=None if auto else pmean,
                           donate=donate, mesh=mesh)
    return step, state, batch, plan, donate


def _lower_train(cfg, model, mesh, mode, spec, policy, rank,
                 opt_dtype="float32", device="cpu", inject=False) -> dict:
    """One flat train step (``dryrun.py:252-323``), ``train_inputs``'s,
    on fake tensors."""
    fake = FakeTensorMode()
    step, state, batch, plan, donate = train_inputs(
        cfg, model, mesh, mode, spec, policy, rank, opt_dtype=opt_dtype,
        device=device, inject=inject, tensors=fake)
    with fake:
        counter, _, arg_b, out_b, alias_b = _count(
            step, (state, batch), _pod_size(mesh),
            donated=state if donate else None)
    rec = _record(counter, argument_bytes=arg_b, output_bytes=out_b,
                  alias_bytes=alias_b)
    rec["policy"] = policy if plan.ranks else "none"
    rec["compressed_leaves"] = len(plan.ranks)
    rec["guarded"] = bool(inject)
    return rec


def _lower_train_pipelined(cfg, sizes, spec, policy, rank,
                           opt_dtype="float32", device="cpu", stash="replay",
                           stash_every=2, overlap=False, chunk_bytes=0,
                           production=True) -> dict:
    """The pipelined train step (``dryrun.py:326-430``), 1F1B with the
    per-stage DP sync, MPMD: stage s runs once as its lead rank (the first
    rank of its slice of the first pod), each in a process of its own with
    its own fake world, all stages at once."""
    import concurrent.futures
    import multiprocessing

    S = cfg.num_stages
    stage_ranks = math.prod(v for k, v in sizes.items() if k != "pod") // S
    jobs = [dict(cfg=cfg, sizes=sizes, spec=spec, policy=policy, rank=rank,
                 opt_dtype=opt_dtype, device=device, stash=stash,
                 stash_every=stash_every, overlap=overlap,
                 chunk_bytes=chunk_bytes, production=production, stage=s,
                 lead=s * stage_ranks) for s in range(S)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            S, mp_context=ctx, initializer=_exit_with_parent,
            initargs=(os.getpid(),)) as pool:
        stages = list(pool.map(_stage_record, jobs))
    # every stage builds the whole model's plan: stage 0's describes them all
    shared = [r.pop("shared") for r in stages][0]
    top = max(stages, key=lambda r: r["flops_per_chip"])
    rec = {k: v for k, v in top.items() if k not in ("stage", "rank")}
    rec["stages"] = stages
    rec["policy"] = policy if shared["compressed_leaves"] else "none"
    rec["compressed_leaves"] = shared["compressed_leaves"]
    rec["pipeline"] = shared["pipeline"]
    return rec


def _exit_with_parent(parent: int) -> None:
    """A stage worker ends when the process that started it is gone (one
    that was killed cannot shut its pool down)."""
    import threading

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def stage_inputs(job: dict, seed: int = 0) -> dict:
    """One pipeline stage's step and its arguments as rank ``job["lead"]``
    of the fake world the caller made: ``{mesh, fake, step, state, batch,
    plan, leaves, part, splans, boundary}``, the state and batch made under
    ``fake`` (a ``FakeTensorMode``), in which the step is to run. The dry
    run counts it (``_stage_record``); the audit logs its collectives
    (``launch/audit.py``)."""
    from repro_torch.pipeline import partition as ppart
    from repro_torch.pipeline import sync as psync
    from repro_torch.pipeline.config import PipelineConfig
    from repro_torch.pipeline.executor import DistPipe, host_state
    from repro_torch.pipeline.schedule import boundary_nbytes

    cfg, sizes, device = job["cfg"], job["sizes"], job["device"]
    S = cfg.num_stages
    dev = _check_device(device)
    model = build_model(cfg)
    acfg = adam.AdamConfig(opt_dtype=job["opt_dtype"])
    sync = SyncConfig()
    mesh = _build_mesh(dev, sizes, job["production"])
    s = dist.get_rank(mesh.get_group("pipe"))
    if s != job["stage"]:
        raise RuntimeError(f"rank {job['lead']} is not in stage "
                           f"{job['stage']}")
    pmean = make_dp_pmean(dp_group(mesh))
    transport = DistPipe(S, group=mesh.get_group("pipe"))
    fake = FakeTensorMode()
    with fake:
        params = model.init(seed, device)
        leaves, plan = _train_plan(cfg, params, "dp_tp", job["policy"],
                                   job["rank"], S)
        part = ppart.make_partition(model, S, remat=cfg.remat)
        stage_p, shared_p = part.partition_params(params)
        splans = psync.make_stage_plans(
            plan, S, psync.stage_local_leaves(stage_p),
            bucket_bytes=sync.bucket_bytes,
            chunk_bytes=job["chunk_bytes"],
            local_path=part.local_leaf_path)
        ost = adam.init({"stage": stage_p, "shared": shared_p}, acfg)
        comp = psync.init_pipeline_comp_state(params, plan, 1, splans,
                                              device=device)
        state = {"stage_params": stage_p, "shared_params": shared_p,
                 "opt_m": ost.m, "opt_v": ost.v, "opt_step": ost.step,
                 "comp": comp}
        state = distribute_state(host_state(state, (s,)), mesh["model"])
        specs = input_specs(cfg, job["spec"])
        rows = _local_rows(job["spec"]["global_batch"], mesh)
        batch = _local_batch(specs, rows, device)
        # a microbatch (the executor's default count: S), crossing the
        # stage boundaries
        boundary = boundary_nbytes(
            part, _local_batch(specs, max(1, rows // S), device))
    scfg = TrainStepConfig(
        mode="dp_tp", policy_plan=plan, measure_entropy=True,
        remat=cfg.remat, adam=acfg, sync=sync,
        pipeline=PipelineConfig(
            num_stages=S, schedule="1f1b", stash_policy=job["stash"],
            stash_every=job["stash_every"], overlap_sync=job["overlap"],
            chunk_bytes=job["chunk_bytes"]))
    step = make_train_step(model, scfg, psum_mean=pmean, pipe=transport,
                           mesh=mesh)
    return dict(mesh=mesh, fake=fake, step=step, state=state, batch=batch,
                plan=plan, leaves=leaves, part=part, splans=splans,
                boundary=boundary)


def _stage_record(job: dict, seed: int = 0) -> dict:
    """One pipeline stage's record, counted as its lead rank ``job["lead"]``
    of a fake world of its own (a process of its own)."""
    from repro_torch.pipeline import sync as psync
    from repro_torch.pipeline.schedule import (peak_activation_bytes,
                                               plan_overlap)

    cfg, sizes, s = job["cfg"], job["sizes"], job["stage"]
    S = cfg.num_stages
    with fake_world(math.prod(sizes.values()), rank=job["lead"]):
        b = stage_inputs(job, seed)
        plan, leaves, part, splans = b["plan"], b["leaves"], b["part"], \
            b["splans"]
        with b["fake"]:
            counter, _, arg_b, out_b, _ = _count(
                b["step"], (b["state"], b["batch"]), _pod_size(b["mesh"]))
    pipeline = {
        "num_stages": S, "schedule": "1f1b", "family": cfg.family,
        "distinct_plans": len(splans.distinct),
        "stage_bytes": psync.stage_wire_bytes(leaves, plan, S),
        "stash_policy": job["stash"],
        # per-rank microbatch boundary bytes x the stash policy's live
        # ring entries from the tick table
        "peak_activation_bytes": peak_activation_bytes(
            "1f1b", S, S, job["stash"], boundary_bytes=b["boundary"],
            n_units=part.num_units(), stash_every=job["stash_every"]),
    }
    if job["overlap"]:
        oplan = plan_overlap("1f1b", S, S, splans)
        pipeline["overlap"] = {
            "chunk_bytes": job["chunk_bytes"],
            "in_loop_chunks": [sum(len(ids) for _, ids in oplan.launches[t])
                               for t in range(S)],
            "residual_chunks": [len(oplan.residual[t]) for t in range(S)],
            "feasible": list(oplan.feasible),
        }
    return dict(_record(counter, argument_bytes=arg_b, output_bytes=out_b,
                        alias_bytes=0), stage=s, rank=job["lead"],
                shared={"compressed_leaves": len(plan.ranks),
                        "pipeline": pipeline})


def _gather_model(t):
    """A DTensor output replicated over ``model`` (kept split over the
    data axes) as this rank's local tensor: the reference's
    ``out_shardings`` (``batch_pspec``) hold outputs whole over ``model``."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    pl = [p if n in ("pod", "data") else Replicate()
          for n, p in zip(mesh.mesh_dim_names, t.placements)]
    return t.redistribute(mesh, pl).to_local()


def _place_params(params, mesh, mode):
    if mode == "auto":
        return distribute_state({"params": params}, mesh, fsdp=True)["params"]
    return distribute_state({"params": params}, mesh["model"])["params"]


def _lower_prefill(cfg, model, mesh, mode, spec, device="cpu",
                   seed: int = 0) -> dict:
    """The full-sequence forward (``dryrun.py:433-447``)."""
    B = spec["global_batch"]
    prefill = make_prefill_step(model)
    fake = FakeTensorMode()
    with fake:
        params = _place_params(model.init(seed, device), mesh, mode)
        batch = _local_batch(input_specs(cfg, spec), _local_rows(B, mesh),
                             device)

        def run(params, batch):
            if mode == "auto":
                batch = {k: _split_rows(v, mesh) for k, v in batch.items()}
            with tp.model_context(True):
                return _gather_model(prefill(params, batch))

        counter, _, arg_b, out_b, _ = _count(run, (params, batch),
                                             _pod_size(mesh))
    return _record(counter, argument_bytes=arg_b, output_bytes=out_b,
                   alias_bytes=0)


def _local_cache(cache, mesh, rows: int):
    """This rank's slice of a decode cache: K/V heads split over ``model``
    where ``cache_pspecs`` splits them (the batch is already local)."""
    sub = mesh["model"]
    specs = sharding.cache_pspecs(cache, {"model": sub.size()}, rows)

    def cut(t, sp):
        pl = sharding.to_placements(sp, sub)
        loc = sharding.local_chunk(t, pl, sub)
        return loc if loc.shape == t.shape else loc.contiguous().clone()

    return tree.unflatten(cache, [cut(t, sp) for t, sp in
                                  zip(tree.leaves(cache),
                                      sharding.spec_leaves(specs))])


def _lower_decode(cfg, model, mesh, mode, spec, device="cpu",
                  seed: int = 0) -> dict:
    """One decode token against a ``seq_len``-deep cache
    (``dryrun.py:450-474``); Whisper's cache from ``encdec.init_cache``.
    The cache is donated, as the reference's ``donate_argnums=1``."""
    B, T = spec["global_batch"], spec["seq_len"]
    serve = make_serve_step(model)
    rows = _local_rows(B, mesh)
    fake = FakeTensorMode()
    with fake:
        params = _place_params(model.init(seed, device), mesh, mode)
        if cfg.family == "whisper":
            from repro_torch.models import encdec
            cache = encdec.init_cache(cfg, rows, T, device=device)
        else:
            cache = model.init_cache(rows, T, device=device)
        cache = _local_cache(cache, mesh, rows)
        tokens = torch.zeros((rows,), dtype=torch.long, device=device)

        def run(params, cache, tokens):
            if mode == "auto":
                tokens = _split_rows(tokens, mesh)
            with tp.model_context(True):
                logits, cache = serve(params, cache, tokens)
            return _gather_model(logits), cache

        counter, _, arg_b, out_b, alias_b = _count(
            run, (params, cache, tokens), _pod_size(mesh), donated=cache)
    return _record(counter, argument_bytes=arg_b, output_bytes=out_b,
                   alias_bytes=alias_b)


def _lower_outer_sync(cfg, model, n_pods: int, rank: int, device="cpu",
                      seed: int = 0) -> dict:
    """The DiLoCo outer sync (``dryrun.py:208-249``): the plan's outer
    wire bytes a round, fp32 deltas. The port's outer loop keeps every
    pod in one process (``PodCarrier``, ROADMAP item 10b), so the step
    runs every pod's program here: FLOPs and bytes are one pod's share
    (the count over ``n_pods``), and the cross-pod collective bytes are
    null."""
    from repro_torch.core.entropy import GDSConfig
    from repro_torch.core.powersgd import LowRankState
    from repro_torch.dist.collectives import PodCarrier
    from repro_torch.optim.outer import make_outer_sync_step

    fake = FakeTensorMode()
    with fake:
        params = model.init(seed, device)
        leaves = classify_leaves(params, cfg.num_layers, 1, min_dim=128)
        plan = make_plan("fixed", leaves, fixed_rank=rank, num_stages=1)
        stack = lambda t: torch.zeros((n_pods,) + tuple(t.shape),
                                      dtype=torch.float32, device=device)
        delta = tree.tree_map(stack, params)
        comp = {p: LowRankState(q=stack(st.q), err=stack(st.err))
                for p, st in init_compressor_state(params, plan, 2).items()}
        step = make_outer_sync_step(PodCarrier(n_pods, [device] * n_pods),
                                    plan, GDSConfig())
        counter, _, _, _, _ = _count(step, (delta, comp), 0)
    walked = counter.result()
    compressed, full = plan_wire_bytes(leaves, plan, 4)
    return {"flops_per_chip": walked["flops"] / n_pods,
            "bytes_per_chip": walked["bytes"] / n_pods,
            "collective_cross_pod": None,
            "collective_cross_total": None,
            "cross_pod_reason": "pods share one process (ROADMAP item 10b)",
            "n_pods": int(n_pods), "outer_rank": int(rank),
            "compressed_leaves": len(plan.ranks),
            "wire_bytes_compressed": int(compressed),
            "wire_bytes_full": int(full)}


# ------------------------------------------------------------------- main
def record_summary(rec: dict) -> dict:
    """Machine-checkable summary of one record, the structured twin of the
    OK/SKIP/FAIL line, emitted as a ``dryrun`` event
    (``dryrun.py:478-519``)."""
    out = {"arch": rec.get("arch"), "shape": rec.get("shape")}
    if rec.get("skipped"):
        out["status"] = "skipped"
        out["reason"] = rec.get("reason")
        return out
    if "error" in rec:
        out["status"] = "failed"
        out["error"] = rec["error"]
        return out
    out["status"] = "ok"
    for key in ("flops_per_chip", "bytes_per_chip", "collective_total",
                "compile_s", "policy", "compressed_leaves", "guarded"):
        if key in rec:
            out[key] = rec[key]
    mem = rec.get("memory")
    if mem:
        out["per_chip_bytes"] = int(mem.get("argument_bytes", 0)
                                    + mem.get("temp_bytes", 0))
    pipe = rec.get("pipeline")
    if pipe:
        out["pipeline"] = {
            "num_stages": pipe.get("num_stages"),
            "schedule": pipe.get("schedule"),
            "stash_policy": pipe.get("stash_policy"),
            "stage_bytes": pipe.get("stage_bytes"),
            "peak_activation_bytes": pipe.get("peak_activation_bytes"),
        }
        if "overlap" in pipe:
            out["pipeline"]["overlap"] = pipe["overlap"]
    osync = rec.get("outer_sync")
    if osync and not osync.get("skipped"):
        out["outer_sync"] = {
            "wire_bytes_compressed": osync.get("wire_bytes_compressed"),
            "wire_bytes_full": osync.get("wire_bytes_full"),
            "outer_k": osync.get("outer_k"),
            "outer_rank": osync.get("outer_rank"),
        }
    return out


def _ok_line(tag: str, rec: dict) -> str:
    mem = rec["memory"]
    per_chip_gb = (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
    extra = ""
    if "pipeline" in rec:
        sb = ";".join(str(c) for c, _ in rec["pipeline"]["stage_bytes"])
        extra = f", {rec['pipeline']['family']} stage-sync [{sb}] B"
        if "overlap" in rec["pipeline"]:
            ov = rec["pipeline"]["overlap"]
            extra += (f", overlap in-loop {ov['in_loop_chunks']} "
                      f"residual {ov['residual_chunks']}")
    if rec.get("guarded"):
        extra += ", guarded"
    osync = rec.get("outer_sync")
    if osync and not osync.get("skipped"):
        extra += (f", outer-sync {osync['wire_bytes_compressed']/2**20:.1f}"
                  f"/{osync['wire_bytes_full']/2**20:.1f} MiB"
                  f" (K={osync['outer_k']}, r={osync['outer_rank']})")
    return (f"OK   {tag}: {rec['flops_per_chip']:.3e} FLOP/chip, "
            f"{rec['bytes_per_chip']:.3e} B/chip, "
            f"coll {rec['collective_total']/2**20:.1f} MiB/chip, "
            f"mem {per_chip_gb:.2f} GiB/chip, {rec['compile_s']}s{extra}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None,
                    help="one input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 (512-rank) mesh")
    ap.add_argument("--pipe", type=int, default=0,
                    help="pipeline stages: adds a 'pipe' mesh axis and runs "
                         "the pipelined (1F1B) train step, stage by stage")
    ap.add_argument("--policy", default="edgc")
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--stash", default="replay",
                    choices=["replay", "full", "every_k"],
                    help="pipeline activation-stash policy (with --pipe)")
    ap.add_argument("--stash-every", type=int, default=2,
                    help="k for --stash every_k")
    ap.add_argument("--overlap", action="store_true",
                    help="with --pipe: the overlapped per-stage sync")
    ap.add_argument("--chunk-bytes", type=int, default=0,
                    help="with --overlap: max bytes per sync chunk "
                         "(0 = one chunk per bucket)")
    ap.add_argument("--outer-k", type=int, default=0,
                    help="with --multi-pod: also count the DiLoCo outer "
                         "sync; K = inner steps per round")
    ap.add_argument("--outer-rank", type=int, default=32,
                    help="PowerSGD rank of the outer sync")
    ap.add_argument("--inject", action="store_true",
                    help="the fault-guarded train step (non-finite guard + "
                         "injection channel)")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors: cuda (default; needs "
                         "a CUDA build of torch) or cpu")
    ap.add_argument("--out", default=None, help="write JSON records here")
    ap.add_argument("--metrics-dir", default=None,
                    help="also emit one 'dryrun' event per combo to "
                         "DIR/metrics.jsonl")
    args = ap.parse_args(argv)
    _check_device(args.device)

    registry = None
    if args.metrics_dir:
        from repro_torch.obs import JsonlSink, MetricsRegistry
        registry = MetricsRegistry(
            [JsonlSink(os.path.join(args.metrics_dir, "metrics.jsonl"))])

    archs = [args.arch] if args.arch else [a for a in ARCHS if a != "gpt2"]
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    mesh_name = "x".join(map(str, production_sizes(
        multi_pod=args.multi_pod, pipe=args.pipe).values()))

    records = []
    for arch in archs:
        for shape_name in shapes:
            tag = f"{arch} x {shape_name} [{mesh_name}]"
            try:
                rec = lower_one(arch, shape_name, multi_pod=args.multi_pod,
                                pipe=args.pipe, policy=args.policy,
                                rank=args.rank, stash=args.stash,
                                stash_every=args.stash_every,
                                overlap=args.overlap,
                                chunk_bytes=args.chunk_bytes,
                                outer_k=args.outer_k,
                                outer_rank=args.outer_rank,
                                inject=args.inject, device=args.device)
                if rec.get("skipped"):
                    print(f"SKIP {tag}: {rec['reason']}", flush=True)
                else:
                    print(_ok_line(tag, rec), flush=True)
            except Exception as e:
                rec = {"arch": arch, "shape": shape_name, "error": str(e),
                       "traceback": traceback.format_exc()}
                print(f"FAIL {tag}: {e}", flush=True)
            records.append(rec)
            if registry is not None:
                registry.event("dryrun", **record_summary(rec))
                registry.flush()
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(records, f, indent=1)

    n_ok = sum(1 for r in records if "flops_per_chip" in r)
    n_skip = sum(1 for r in records if r.get("skipped"))
    n_fail = len(records) - n_ok - n_skip
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if registry is not None:
        registry.event("dryrun_summary", ok=n_ok, skipped=n_skip,
                       failed=n_fail)
        registry.close()
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
