"""Collective-safety audit: checks over recorded train steps, rank by rank.

Port of ``repro/launch/audit.py``. The reference walks the closed jaxprs
of representative step variants; the port runs each variant once per rank
and records what the rank launches (``analysis.dispatch_log.CollectiveLog``):

  * **collective parity**: every member of a process group issues the same
    collectives on it in the same order, and every pipe send meets its
    receive (``analysis.parity``);
  * **psum budgets**: each labelled launch of the overlapped executor
    issues exactly the collectives the overlap planner declared, and the
    entropy-off step issues exactly ``ENTROPY_PSUMS`` fewer all-reduces
    (``analysis.budget``);
  * **host syncs**: no op of the step reads a device value on the host (on
    CUDA, under the sync debug mode, none synchronises at all), and a short
    real run keeps the trainer's step cache window-bounded
    (``analysis.hostcalls``);
  * **source lint**: duplicate dict keys, host calls in hot paths,
    collectives without a group, unhashable cache keys
    (``analysis.lint``).

**Every rank runs in a fake world.** Each rank of a variant runs in a
fake process group of the variant's world (``dryrun.fake_world``), so a
rank that diverges cannot hang the others; the ranks are jobs of a pool
of spawned processes (a fake group is process-global), and the parent
gathers their logs and checks them. The built-in variants run on real
tensors at tiny widths (``FAMILY_CFGS``); zoo mode (``--arch``) runs one
config at its published widths on fake tensors over the production mesh,
each stage's lead rank and that rank's data peer. Parity is checked over
the logs of the ranks run, not proven over all inputs as the reference's
static walk is.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.audit --device cpu # everything
  PYTHONPATH=src python -m repro_torch.launch.audit              # on the card
  PYTHONPATH=src python -m repro_torch.launch.audit --lint-only
  PYTHONPATH=src python -m repro_torch.launch.audit --skip-train --device cpu
  PYTHONPATH=src python -m repro_torch.launch.audit --arch qwen2-0.5b \\
      --shape train_4k --pipe 2 --overlap --device cpu             # zoo config

``--device`` is ``cuda`` by default (it raises without a card); the exit
status is 1 when any violation survives.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import sys
import time

import numpy as np
import torch

from repro_torch import analysis
from repro_torch.analysis.lint import LINT_ROOTS
from repro_torch.core.config import SyncConfig
from repro_torch.launch.mesh import dp_group, dp_index, dp_size
from repro_torch.models.model import ModelConfig, build_model

__all__ = ["FAMILY_CFGS", "KNOWN_HOST_SYNCS", "LINT_ROOTS", "Report",
           "build_flat", "build_pipelined", "main", "rank_job", "run_jobs"]

# Tiny but representative configs: one per pipeline family adapter, all
# 2-stage (zamba ragged, 3 layers over 2 stages), the reference's.
FAMILY_CFGS = {
    "dense": ModelConfig(name="audit-dense", family="dense", num_layers=4,
                         d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=512, num_stages=2),
    "moe": ModelConfig(name="audit-moe", family="moe", num_layers=4,
                       d_model=128, num_heads=4, num_kv_heads=2, d_ff=128,
                       vocab_size=512, num_experts=2, experts_per_token=1,
                       capacity_factor=4.0, num_stages=2),
    "xlstm": ModelConfig(name="audit-xlstm", family="xlstm", num_layers=4,
                         d_model=128, num_heads=2, num_kv_heads=2,
                         vocab_size=512, chunk=16, num_stages=2),
    "zamba": ModelConfig(name="audit-zamba", family="zamba", num_layers=3,
                         d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
                         vocab_size=512, ssm_state=16, chunk=16,
                         attn_every=2, num_stages=2),
    "whisper": ModelConfig(name="audit-whisper", family="whisper",
                           num_layers=2, encoder_layers=2, d_model=128,
                           num_heads=4, num_kv_heads=4, d_ff=256,
                           vocab_size=512, audio_frames=16,
                           max_position=512, num_stages=2),
    "vlm": ModelConfig(name="audit-vlm", family="vlm", num_layers=2,
                       d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
                       vocab_size=512, num_patches=4, num_stages=2),
}

#: Host syncs the built-in steps are known to make, ``"op@line"`` -> why;
#: the host-sync targets allow them and flag every other
KNOWN_HOST_SYNCS: dict[str, str] = {}

B, T = 8, 16                    # the global batch of every built-in step
DATA = 2                        # the data-parallel world of the built-ins


# ------------------------------------------------------------------ builds
def _family_batch(cfg: ModelConfig, rows: int, device, seed: int = 0
                  ) -> dict:
    """``rows`` rows of T tokens (and the family's modality stubs) drawn
    from ``seed`` with numpy, on ``device``."""
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (rows, T)),
                           dtype=torch.long, device=device)
    batch = {"tokens": toks, "labels": toks.clone()}
    stub = lambda n: torch.as_tensor(
        rng.standard_normal((rows, n, cfg.d_model)),
        dtype=cfg.torch_dtype, device=device)
    if cfg.family == "whisper":
        batch["frames"] = stub(cfg.audio_frames)
    if cfg.family == "vlm":
        batch["patches"] = stub(cfg.num_patches)
    return batch


def _dp_pmean(mesh):
    from repro_torch.dist.collectives import make_dp_pmean
    return make_dp_pmean(dp_group(mesh))


def build_flat(cfg: ModelConfig, mesh, device, *, measure_entropy=True,
               sync: SyncConfig | None = None, rank: int = 8):
    """The flat bucketed step (``_trace_flat``'s) on this rank of a
    ``(data,)`` mesh: (step, state, batch, layout)."""
    from repro_torch.core.bucketing import make_bucket_layout
    from repro_torch.core.compressor import (classify_leaves,
                                             init_compressor_state, make_plan)
    from repro_torch.optim import adam
    from repro_torch.train.step import TrainStepConfig, make_train_step

    model = build_model(cfg)
    params = model.init(0, device)
    leaves = classify_leaves(params, cfg.num_layers, 1, min_dim=64)
    plan = make_plan("edgc", leaves, stage_ranks=[rank], num_stages=1)
    sync = sync or SyncConfig(bucketed=True)
    layout = make_bucket_layout(leaves, plan, sync.bucket_bytes)
    ost = adam.init(params, adam.AdamConfig())
    comp = init_compressor_state(params, plan, 1, layout=layout,
                                 wire_ef=sync.wire != "raw")
    state = {"params": params, "opt_m": ost.m, "opt_v": ost.v,
             "opt_step": ost.step, "comp": comp}
    scfg = TrainStepConfig(mode="dp_tp", policy_plan=plan,
                           measure_entropy=measure_entropy, sync=sync)
    step = make_train_step(model, scfg, psum_mean=_dp_pmean(mesh))
    batch = _family_batch(cfg, B // dp_size(mesh), device,
                          seed=dp_index(mesh))
    return step, state, batch, layout


def build_pipelined(cfg: ModelConfig, mesh, device, *, overlap: bool,
                    measure_entropy: bool = True, chunk_bytes: int = 1 << 16,
                    sync: SyncConfig | None = None, rank: int = 8):
    """The pipelined 1F1B step (``_trace_pipelined``'s: M = 2S
    microbatches, edgc at rank 8) of this rank's stage of a ``(pipe,
    data)`` mesh, over ``DistPipe`` on the pipe group and the DP mean on
    the stage's pod x data group, as the trainer runs it: (step, state, batch,
    {"oplan", "splans"})."""
    from repro_torch.core.compressor import classify_leaves, make_plan
    from repro_torch.optim import adam
    from repro_torch.pipeline import partition as ppart
    from repro_torch.pipeline import sync as psync
    from repro_torch.pipeline.config import PipelineConfig
    from repro_torch.pipeline.executor import DistPipe, host_state
    from repro_torch.pipeline.schedule import plan_overlap
    from repro_torch.train.step import TrainStepConfig, make_train_step

    S = cfg.num_stages
    M = 2 * S
    model = build_model(cfg)
    params = model.init(0, device)
    leaves = classify_leaves(params, cfg.num_layers, S, min_dim=64)
    plan = make_plan("edgc", leaves, stage_ranks=[rank] * S, num_stages=S)
    part = ppart.make_partition(model, S)
    stage_p, shared_p = part.partition_params(params)
    sync = sync or SyncConfig()
    splans = psync.make_stage_plans(
        plan, S, psync.stage_local_leaves(stage_p),
        bucket_bytes=sync.bucket_bytes, chunk_bytes=chunk_bytes,
        local_path=part.local_leaf_path)
    ost = adam.init({"stage": stage_p, "shared": shared_p},
                    adam.AdamConfig())
    comp = psync.init_pipeline_comp_state(params, plan, 1, splans,
                                          wire_ef=sync.wire != "raw",
                                          device=device)
    pipe = DistPipe(S, group=mesh.get_group("pipe"))
    state = host_state({"stage_params": stage_p, "shared_params": shared_p,
                        "opt_m": ost.m, "opt_v": ost.v, "opt_step": ost.step,
                        "comp": comp}, pipe.stages)
    scfg = TrainStepConfig(
        mode="dp_tp", policy_plan=plan, measure_entropy=measure_entropy,
        pipeline=PipelineConfig(num_stages=S, schedule="1f1b",
                                num_microbatches=M, overlap_sync=overlap,
                                chunk_bytes=chunk_bytes),
        sync=sync)
    step = make_train_step(model, scfg, psum_mean=_dp_pmean(mesh), pipe=pipe)
    batch = _family_batch(cfg, B // dp_size(mesh), device,
                          seed=dp_index(mesh))
    oplan = plan_overlap("1f1b", S, M, splans) if overlap else None
    return step, state, batch, {"oplan": oplan, "splans": splans}


# ----------------------------------------------------------------- one rank
def _record(step, state, batch, device, fake=None) -> analysis.RankLog:
    """One step under a fresh log, on CUDA under the sync debug mode (a
    backward op's sync is named by its autograd node)."""
    log = analysis.CollectiveLog(sync_debug=device.type == "cuda")
    with fake or contextlib.nullcontext(), log:
        step(state, batch)
    return log.freeze()


def rank_job(job: dict):
    """Run one rank of one variant in a fake world of its own (this
    process must hold no process group); returns (its RankLog, extra)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    device = dryrun._check_device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    kind = job["kind"]
    if kind == "zoo":
        return _zoo_rank(job, device)
    cfg = job["cfg"]
    sync = job.get("sync")
    world = DATA * (cfg.num_stages if kind == "pipelined" else 1)
    with dryrun.fake_world(world, rank=job["rank"]):
        if kind == "flat":
            mesh = make_host_mesh(data=DATA, device_type=device.type)
            step, state, batch, _ = build_flat(
                cfg, mesh, device, measure_entropy=job["entropy"], sync=sync)
            extra = {}
        else:
            mesh = make_host_mesh(pipe=cfg.num_stages, data=DATA,
                                  device_type=device.type)
            step, state, batch, extra = build_pipelined(
                cfg, mesh, device, overlap=job["overlap"],
                measure_entropy=job["entropy"], sync=sync)
        return _record(step, state, batch, device), extra


def _zoo_rank(job: dict, device):
    """One rank of a zoo config at its published widths on fake tensors
    over the production mesh: a pipeline stage (``dryrun.stage_inputs``)
    or the flat step (``dryrun.train_inputs``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import sharding_mode
    from repro_torch.launch import dryrun
    from repro_torch.pipeline.schedule import plan_overlap

    sizes = job["sizes"]
    with dryrun.fake_world(math.prod(sizes.values()), rank=job["lead"]):
        if "pipe" in sizes:
            b = dryrun.stage_inputs(job)
            S = job["cfg"].num_stages
            extra = {"splans": b["splans"],
                     "oplan": plan_overlap("1f1b", S, S, b["splans"])
                     if job["overlap"] else None}
            step, state, batch, fake = b["step"], b["state"], b["batch"], \
                b["fake"]
        else:
            cfg = job["cfg"]
            mesh = dryrun._build_mesh(device, sizes, True)
            fake = FakeTensorMode()
            step, state, batch, _, _ = dryrun.train_inputs(
                cfg, build_model(cfg), mesh, sharding_mode(job["arch"]),
                job["spec"], job["policy"], job["rank"], device=job["device"],
                tensors=fake)
            extra = {}
        return _record(step, state, batch, device, fake=fake), extra


def _worker(parent: int) -> None:
    """A pool worker: one host thread for torch's ops (the workers run side
    by side), and gone when the process that started it is."""
    from repro_torch.launch.dryrun import _exit_with_parent
    torch.set_num_threads(1)
    _exit_with_parent(parent)


def run_jobs(jobs: list[dict]) -> list:
    """Every job in a pool of spawned processes (four, or two sharing one
    card); returns their futures in order."""
    cuda = any(job["device"] != "cpu" for job in jobs)
    workers = min(2 if cuda else 4, len(jobs), os.cpu_count() or 1)
    pool = concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_worker, initargs=(os.getpid(),))
    futures = [pool.submit(rank_job, job) for job in jobs]
    pool.shutdown(wait=False)
    return futures


class _Jobs:
    """The variants' rank jobs, submitted once each and shared by the
    targets that read them."""

    def __init__(self, device: str) -> None:
        self.device = device
        self.jobs: dict[tuple, dict] = {}
        self.futures: dict[tuple, concurrent.futures.Future] = {}

    def want(self, key: tuple, **job) -> tuple:
        self.jobs.setdefault(key, dict(job, device=self.device))
        return key

    def start(self) -> None:
        futures = run_jobs(list(self.jobs.values()))
        self.futures = dict(zip(self.jobs, futures))

    def get(self, key: tuple):
        return self.futures[key].result()


# ------------------------------------------------------------------ report
class Report:
    """Violation accumulator with per-target timing."""

    def __init__(self) -> None:
        self.violations: list[tuple[str, analysis.Violation]] = []
        self.targets: list[dict] = []

    def run(self, name: str, fn) -> None:
        t0 = time.time()
        try:
            found = fn()
        except Exception as e:                       # surface, don't crash
            found = [analysis.Violation(
                rule="audit-error", path=name,
                message=f"{type(e).__name__}: {e}")]
        dt = round(time.time() - t0, 1)
        self.violations.extend((name, v) for v in found)
        self.targets.append({"target": name, "violations": len(found),
                             "seconds": dt})
        status = "ok" if not found else f"{len(found)} VIOLATION(S)"
        print(f"  {name:<44} {status}  ({dt}s)", flush=True)
        for v in found:
            print(f"    {v}", flush=True)

    def as_json(self) -> dict:
        return {"targets": self.targets,
                "violations": [{"target": t, "rule": v.rule, "path": v.path,
                                "message": v.message}
                               for t, v in self.violations]}


def _host_syncs(logs: dict) -> list:
    out = []
    for r in sorted(logs):
        out.extend(analysis.Violation(v.rule, f"rank={r}/{v.path}", v.message)
                   for v in analysis.check_host_transfers(
                       logs[r], allow=KNOWN_HOST_SYNCS))
    return out


# ------------------------------------------------------------------ targets
def _flat_key(jobs: _Jobs, rank: int, entropy: bool = True) -> tuple:
    cfg = dataclasses.replace(FAMILY_CFGS["dense"], num_stages=1)
    return jobs.want(("flat", rank, entropy), kind="flat", cfg=cfg,
                     rank=rank, entropy=entropy)


def _pipe_key(jobs: _Jobs, fam: str, rank: int, *, entropy: bool = True,
              sync: SyncConfig | None = None, tag: str = "") -> tuple:
    return jobs.want(("pipelined", fam + tag, rank, entropy),
                     kind="pipelined", cfg=FAMILY_CFGS[fam], rank=rank,
                     entropy=entropy, overlap=True, sync=sync)


def _want_flat(jobs: _Jobs) -> list:
    return [_flat_key(jobs, r) for r in range(DATA)]


def _audit_flat(rep: Report, jobs: _Jobs, keys: list) -> None:
    logs: dict = {}

    def go():
        logs.update({r: jobs.get(k)[0] for r, k in enumerate(keys)})
        return analysis.check_collective_parity(logs)

    rep.run("dense:flat:parity", go)
    if logs:
        rep.run("dense:flat:host-sync", lambda: _host_syncs(logs))


def _want_family(jobs: _Jobs, fam: str, sync=None, tag: str = "") -> list:
    world = DATA * FAMILY_CFGS[fam].num_stages
    return [_pipe_key(jobs, fam, r, sync=sync, tag=tag) for r in range(world)]


def _audit_step_family(rep: Report, jobs: _Jobs, fam: str, keys: list,
                       tag: str = "") -> None:
    """Parity, declared-budget and host-sync audit of one family's
    overlapped pipelined step at (pipe 2, data 2)."""
    name = f"{fam}{tag}:pipelined-overlapped"
    holder: dict = {}

    def go():
        runs = [jobs.get(k) for k in keys]
        holder["logs"] = {r: log for r, (log, _) in enumerate(runs)}
        holder.update(runs[0][1])
        return analysis.check_collective_parity(holder["logs"])

    rep.run(f"{name}:parity", go)
    if not holder:
        return
    rep.run(f"{name}:psum-budget",
            lambda: analysis.check_overlap_branches(
                holder["logs"], holder["oplan"], holder["splans"]))
    rep.run(f"{name}:host-sync", lambda: _host_syncs(holder["logs"]))


def _audit_entropy_gates(rep: Report, jobs: _Jobs, keys: dict) -> None:
    def gate(on, off, delta, where):
        return lambda: analysis.check_entropy_gate(
            jobs.get(on)[0], jobs.get(off)[0], delta, where=where)

    rep.run("dense:pipelined:entropy-gate",
            gate(keys["pipe_on"], keys["pipe_off"], analysis.ENTROPY_PSUMS,
                 "dense:pipelined"))
    # the flat step measures entropy on already-synced grads: the off
    # variant must launch ZERO fewer collectives (pure compute gate)
    rep.run("dense:flat:entropy-gate",
            gate(keys["flat_on"], keys["flat_off"], 0, "dense:flat"))


def _audit_trainer_cache(rep: Report, device: str) -> None:
    """Short REAL run at world 1; prove the step variants stay
    window-bounded."""
    from repro_torch.core import EDGCConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(FAMILY_CFGS["dense"], num_layers=2, d_model=64,
                              d_ff=128, num_stages=1)

    def go():
        model = build_model(cfg)
        edgc = EDGCConfig()
        edgc = dataclasses.replace(
            edgc, dac=dataclasses.replace(edgc.dac, window=3))
        tr = Trainer(model, edgc, TrainerConfig(total_steps=6, log_every=100),
                     device=device)
        rng = np.random.default_rng(0)

        def data():
            while True:
                toks = rng.integers(0, cfg.vocab_size,
                                    (8, 16)).astype(np.int32)
                yield {"tokens": toks, "labels": toks}

        tr.run(data())
        return analysis.audit_recompiles(tr)

    rep.run("trainer:recompile-window", go)


def _audit_lint(rep: Report) -> None:
    roots = list(LINT_ROOTS)

    def go():
        return [analysis.Violation(rule=f.rule, path=f"{f.file}:{f.line}",
                                   message=f.message)
                for f in analysis.run_lint(roots)]

    rep.run(f"lint:{','.join(roots)}", go)


def _zoo_jobs(arch: str, shape: str, pipe: int, overlap: bool,
              device: str):
    """(skip reason, jobs): each stage's lead rank and its data peer."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.mesh import production_sizes
    from repro_torch.pipeline.partition import pipeline_supported

    cfg = get_config(arch, "full")
    spec = INPUT_SHAPES[shape]
    if spec["kind"] != "train":
        return f"{shape} is not a train shape", []
    sizes = production_sizes(pipe=pipe)
    S = sizes.get("pipe", 1)
    model = sizes["model"]
    if S > 1:
        cfg = dataclasses.replace(cfg, num_stages=S)
        reason = pipeline_supported(cfg, S)
        if reason is not None:
            return reason, []
    per_stage = math.prod(sizes.values()) // S
    base = dict(kind="zoo", cfg=cfg, arch=arch, sizes=sizes, spec=spec,
                policy="edgc", rank=64, opt_dtype="float32",
                stash="replay", stash_every=2, overlap=overlap,
                chunk_bytes=1 << 22, production=True, device=device)
    jobs = []
    for s in range(S):
        for lead in (s * per_stage, s * per_stage + model):
            jobs.append(dict(base, stage=s, lead=lead))
    return None, jobs


def _audit_zoo(rep: Report, arch: str, shape: str, pipe: int,
               overlap: bool, device: str) -> None:
    """Published-width audit of one zoo config on fake tensors: each
    stage's lead rank and its data peer, each in a fake world of the
    production mesh's ranks."""
    reason, zoo = _zoo_jobs(arch, shape, pipe, overlap, device)
    if reason is not None:
        print(f"  zoo:{arch}: skipped ({reason})")
        return
    futures = run_jobs(zoo)
    holder: dict = {}

    def go():
        runs = [f.result() for f in futures]
        holder["logs"] = {job["lead"]: log
                          for job, (log, _) in zip(zoo, runs)}
        holder.update(runs[0][1])
        return analysis.check_collective_parity(holder["logs"])

    rep.run(f"zoo:{arch}:{shape}:parity", go)
    if not holder:
        return
    rep.run(f"zoo:{arch}:{shape}:host-sync",
            lambda: _host_syncs(holder["logs"]))
    if overlap and holder.get("oplan") is not None:
        rep.run(f"zoo:{arch}:{shape}:psum-budget",
                lambda: analysis.check_overlap_branches(
                    holder["logs"], holder["oplan"], holder["splans"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Collective-safety audit (parity / budgets / host "
                    "syncs / lint) over recorded train-step variants.")
    ap.add_argument("--lint-only", action="store_true")
    ap.add_argument("--skip-lint", action="store_true")
    ap.add_argument("--skip-train", action="store_true",
                    help="skip the short real trainer run (cache audit)")
    ap.add_argument("--families", default=None,
                    help=f"comma list from {sorted(FAMILY_CFGS)} "
                         f"(default: all)")
    ap.add_argument("--arch", default=None,
                    help="audit one zoo config instead of the built-ins")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--pipe", type=int, default=4)
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--out", default=None, help="write a JSON report")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import _check_device
    _check_device(args.device)
    rep = Report()
    print("collective-safety audit", flush=True)
    jobs = _Jobs(args.device)
    if not args.lint_only and not args.arch:
        fams = (args.families.split(",") if args.families
                else list(FAMILY_CFGS))
        flat = _want_flat(jobs)
        gates = {"flat_on": flat[0],
                 "flat_off": _flat_key(jobs, 0, entropy=False),
                 "pipe_on": _want_family(jobs, "dense")[0],
                 "pipe_off": _pipe_key(jobs, "dense", 0, entropy=False)}
        family = {fam: _want_family(jobs, fam) for fam in fams}
        # the wire-coded executor ships packed payloads under the same
        # collectives: the launch budgets must survive the codec
        quant8 = _want_family(jobs, "dense", sync=SyncConfig(wire="quant8"),
                              tag="+quant8")
        jobs.start()
    if not args.skip_lint:
        _audit_lint(rep)
    if args.lint_only:
        pass
    elif args.arch:
        _audit_zoo(rep, args.arch, args.shape, args.pipe, args.overlap,
                   args.device)
    else:
        _audit_flat(rep, jobs, flat)
        _audit_entropy_gates(rep, jobs, gates)
        for fam in fams:
            _audit_step_family(rep, jobs, fam, family[fam])
        _audit_step_family(rep, jobs, "dense", quant8, tag="+quant8")
        if not args.skip_train:
            _audit_trainer_cache(rep, args.device)

    n = len(rep.violations)
    print(f"{len(rep.targets)} target(s), {n} violation(s)", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rep.as_json(), fh, indent=2)
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
