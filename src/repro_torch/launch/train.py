"""Training entry point of the port (flat data-parallel path).

Runs on CUDA unless ``--device`` names another device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 \\
      --variant reduced --policy fixed --rank 32 --steps 200 --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --variant reduced --policy edgc --steps 300 --window 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 \\
      --variant reduced --policy fixed --steps 12 --wire quant8 \\
      --ckpt-every 6 --ckpt-path ckpt/run --device cpu

``--inject`` schedules faults and ``--recover`` arms the recovery
policies; ``--metrics-dir`` writes the run's telemetry, which
``python -m repro_torch.launch.report <dir>`` summarizes:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 \\
      --variant reduced --policy fixed --steps 12 --inject nan_grad@3 \\
      --recover --metrics-dir runs/faults --device cpu

``--pipe S`` partitions the model into S stages and runs the pipelined
executor (GPipe or 1F1B, ``--stash`` policy) with all S stage programs in
this process on the chosen device; ``--trace`` writes the schedule as a
Chrome trace, its ticks scaled to the measured step time; ``--overlap``
launches each stage's sync chunks (flat buckets split at ``--chunk-bytes``)
in the drain ticks, and the trace shows them as SYNC spans:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 \\
      --variant reduced --policy edgc --pipe 4 --micro 4 --steps 12 \\
      --window 4 --batch 4 --seq 32 --overlap --chunk-bytes 65536 \\
      --trace runs/pipe/trace.json --metrics-dir runs/pipe --device cpu

In a world of ``pipe * data-mesh`` processes (``WORLD_SIZE`` and the other
variables ``torch.distributed.run`` sets) each process hosts one stage of
a ``(pipe, data)`` mesh; gloo on the CPU, NCCL with one card per process:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch gpt2 --variant reduced \\
      --policy optimus --pipe 2 --data-mesh 2 --micro 4 --steps 6 \\
      --batch 8 --seq 32 --overlap --chunk-bytes 65536 --device cpu

``--outer-k K`` routes through the elastic (DiLoCo) outer loop:
``--pods`` pod-local flat trainers, all in this process on the chosen
device, K inner steps each per outer round, then the EDGC-compressed
outer-delta all-reduce (``--outer-policy``, ``--outer-rank``,
``--outer-window`` in rounds) and the Nesterov outer update; ``@rN``
faults drop and join pods between rounds (a joiner needs a free pod slot:
there are ``--pods`` of them):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 \\
      --outer-k 5 --pods 2 --rounds 6 --recover \\
      --inject nan_grad@7,pod_drop:1@r2,pod_join@r4 --device cpu

``--model-mesh M`` runs tensor parallelism on a ``(data, model)`` mesh of
``data-mesh * M`` processes (rank = w * M + t; one process is enough for
M = 1, which still runs the DTensor placements and the model-group
collectives). Beside ``--pipe S`` the mesh is ``(pipe, data, model)``
with ``S * data-mesh * M`` processes, one stage each (rank = (s *
data-mesh + w) * M + t); one process runs every stage (LocalPipe) on a
``(data 1, model 1)`` mesh:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.train --arch gpt2 --variant reduced \
      --policy fixed --rank 8 --data-mesh 2 --model-mesh 2 --steps 4 \
      --batch 8 --seq 32 --device cpu
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.train --arch gpt2 --variant reduced \
      --policy fixed --rank 8 --pipe 2 --model-mesh 2 --micro 2 \
      --steps 4 --batch 8 --seq 32 --device cpu

The flags are the reference launcher's, plus ``--device``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import EDGCConfig, GDSConfig, SyncConfig
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM, add_modality_stubs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model
from repro_torch.obs import (load_trace, profiler_session, tick_trace_events,
                             validate_trace, write_chrome_trace)
from repro_torch.optim.adam import AdamConfig
from repro_torch.pipeline import PipelineConfig
from repro_torch.pipeline.partition import pipeline_supported
from repro_torch.pipeline.schedule import simulate_schedule
from repro_torch.train.faults import RecoveryConfig, parse_inject
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2", choices=sorted(ARCHS))
    ap.add_argument("--variant", default="reduced", choices=["full", "reduced"])
    ap.add_argument("--policy", default="edgc",
                    choices=["none", "fixed", "optimus", "edgc"])
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--window", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--stages", type=int, default=0, help="0 = config default")
    ap.add_argument("--pipe", type=int, default=0,
                    help="pipeline stages: partition the model into this "
                         "many stages and run the pipelined (GPipe/1F1B) "
                         "executor, every stage in this process (one stage "
                         "per process in a world of pipe * data-mesh)")
    ap.add_argument("--schedule", default="1f1b", choices=["gpipe", "1f1b"])
    ap.add_argument("--micro", type=int, default=0,
                    help="microbatches per step (0 -> num_stages)")
    ap.add_argument("--stash", default="replay",
                    choices=["replay", "full", "every_k"],
                    help="pipeline activation stashing: replay re-derives "
                         "each stage's forward in its backward; full/every_k "
                         "stash inter-unit carries into a second ring and "
                         "replay only the un-stashed segments")
    ap.add_argument("--stash-every", type=int, default=2,
                    help="k for --stash every_k")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap each stage's DP sync with the pipeline "
                         "drain: sync chunks launch inside the schedule's "
                         "free back-of-drain ticks instead of after the "
                         "loop (pipelined executor only)")
    ap.add_argument("--chunk-bytes", type=int, default=0,
                    help="split flat sync buckets into transfer chunks of "
                         "at most this many bytes for overlap scheduling "
                         "(0 = one chunk per bucket)")
    ap.add_argument("--data-mesh", type=int, default=1,
                    help="data-parallel workers per stage in a world of "
                         "several processes")
    ap.add_argument("--model-mesh", type=int, default=0,
                    help="tensor-parallel processes per data-parallel "
                         "worker: a (data, model) mesh of data-mesh * this "
                         "many processes (0: no model axis)")
    ap.add_argument("--use-kernels", action="store_true",
                    help="run the PowerSGD products through the Hopper kernels")
    ap.add_argument("--wire", default="raw",
                    choices=["raw", "quant8", "quant4", "entropy"],
                    help="wire coding of the DP sync payloads: scaled int8/"
                         "int4 quantization + bit packing with error "
                         "feedback; 'entropy' picks the bit width per window "
                         "from the controller's entropy reading (quant8 "
                         "until the first one)")
    ap.add_argument("--inject", default=None,
                    help="comma-separated fault specs kind[:arg]@N (step) "
                         "or kind[:arg]@rN (outer round); kinds: nan_grad, "
                         "corrupt_payload, torn_ckpt, pod_drop, pod_join. "
                         "e.g. 'nan_grad@40,pod_drop:1@r3'")
    ap.add_argument("--recover", action="store_true",
                    help="arm the recovery policies: non-finite step guard "
                         "+ error-feedback reset, loss-spike rollback to "
                         "the checkpoint ring, uncompressed-sync fallback "
                         "after repeated anomalies")
    ap.add_argument("--spike-factor", type=float, default=4.0,
                    help="loss > factor * EMA counts as an anomaly")
    ap.add_argument("--max-rollbacks", type=int, default=3)
    ap.add_argument("--fallback-after", type=int, default=4,
                    help="anomalies before pinning uncompressed sync")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint cadence in steps (rollback needs > 0)")
    ap.add_argument("--ckpt-path", default="ckpt/state")
    ap.add_argument("--outer-k", type=int, default=0,
                    help="> 0 routes through the elastic outer loop: K "
                         "inner steps per pod per outer round")
    ap.add_argument("--pods", type=int, default=2,
                    help="initial pod count (all pods share the device)")
    ap.add_argument("--rounds", type=int, default=10,
                    help="outer rounds to run")
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--outer-momentum", type=float, default=0.9)
    ap.add_argument("--outer-policy", default="edgc",
                    choices=["none", "fixed", "edgc"],
                    help="outer-delta compression policy")
    ap.add_argument("--outer-rank", type=int, default=32)
    ap.add_argument("--outer-window", type=int, default=2,
                    help="outer DAC window, counted in ROUNDS")
    ap.add_argument("--metrics-dir", default=None,
                    help="write structured telemetry (scalars/series/events) "
                         "as JSONL to <dir>/metrics.jsonl; read it back with "
                         "python -m repro_torch.launch.report <dir>")
    ap.add_argument("--trace", default=None,
                    help="emit a Chrome trace-event JSON of the pipeline "
                         "schedule (Perfetto-loadable) to this path, with "
                         "tick durations scaled to the measured mean step "
                         "time (pipelined runs only)")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="wrap the run in a torch.profiler session and write "
                         "its Chrome trace to LOGDIR/trace.json")
    ap.add_argument("--out", default=None,
                    help="write the history and comm savings as JSON here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    faults = parse_inject(args.inject) if args.inject else None
    recovery = RecoveryConfig(
        spike_factor=args.spike_factor, max_rollbacks=args.max_rollbacks,
        fallback_after=args.fallback_after) if args.recover else None
    if args.trace and not args.pipe:
        raise SystemExit("--trace requires --pipe: the tick tracer renders "
                         "the pipeline schedule")
    if args.outer_k and args.pipe:
        raise SystemExit("--outer-k does not compose with --pipe: the outer "
                         "loop wraps flat pod-local trainers")
    total_steps = args.outer_k * args.rounds if args.outer_k else args.steps
    cfg = get_config(args.arch, args.variant)
    if args.pipe:
        if args.stages and args.stages != args.pipe:
            raise SystemExit(f"--pipe {args.pipe} conflicts with --stages "
                             f"{args.stages}: the pipe size IS the stage "
                             "count")
        num_stages = args.pipe
        cfg = dataclasses.replace(cfg, num_stages=num_stages)
        reason = pipeline_supported(cfg, num_stages)
        if reason is not None:
            raise SystemExit(f"--pipe {args.pipe} unsupported for "
                             f"{cfg.name}: {reason}")
    else:
        num_stages = args.stages or cfg.num_stages
    mesh = _process_mesh(args)
    model = build_model(cfg)
    pipe_cfg = PipelineConfig(
        num_stages=num_stages, schedule=args.schedule,
        num_microbatches=args.micro, stash_policy=args.stash,
        stash_every=args.stash_every, overlap_sync=args.overlap,
        chunk_bytes=args.chunk_bytes)
    sync_cfg = SyncConfig(use_kernels=args.use_kernels, wire=args.wire)
    edgc = EDGCConfig(
        policy=args.policy, fixed_rank=args.rank,
        total_iterations=total_steps,
        gds=GDSConfig(alpha=0.5, beta=0.25),
        dac=DACConfig(window=args.window, adjust_limit=4),
        pipeline=pipe_cfg, sync=sync_cfg,
    )
    tcfg = TrainerConfig(
        total_steps=total_steps, log_every=max(1, total_steps // 20),
        ckpt_every=args.ckpt_every, ckpt_path=args.ckpt_path,
        recovery=recovery, faults=faults, pipeline=pipe_cfg, sync=sync_cfg,
        metrics_dir=args.metrics_dir,
        adam=AdamConfig(lr=args.lr, warmup_steps=max(10, total_steps // 10),
                        total_steps=total_steps),
    )
    if args.outer_k:
        return _elastic(args, cfg, model, edgc, tcfg)
    trainer = Trainer(model, edgc, tcfg, seed=args.seed, device=args.device,
                      pipe=args.pipe or None, mesh=mesh)
    # one process of a mesh speaks and writes the files
    say = print if trainer._writer else (lambda *a, **k: None)
    pipe_tag = (f", pipe={args.pipe} ({args.schedule}, stash={args.stash}"
                f"{', overlapped sync' if args.overlap else ''})"
                if args.pipe else "")
    mesh_tag = (f", mesh data={args.data_mesh} x model={args.model_mesh}"
                if args.model_mesh else "")
    say(f"{cfg.name}: {trainer.n_params/1e6:.1f}M params on {trainer.device}, "
        f"policy={args.policy}{pipe_tag}{mesh_tag}, "
        f"{trainer.controller.describe()}")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       batch_size=args.batch, seed=args.seed)
    # the Whisper and VLM families' batches carry the stubbed frontends'
    # frames and patches
    batches = (add_modality_stubs(b, cfg.family,
                                  audio_frames=cfg.audio_frames,
                                  num_patches=cfg.num_patches,
                                  d_model=cfg.d_model, seed=args.seed)
               for b in data.batches())
    with profiler_session(bool(args.profile), args.profile or "profile"):
        hist = trainer.run(batches)
    for h in hist:
        say(f"step {h['step']:5d} loss {h['loss']:.4f} H {h['entropy']:+.3f} "
            f"ranks {h['ranks']} comm-saved "
            f"{1 - h['bytes_synced']/max(1, h['bytes_full']):.1%}")
    say(f"final comm savings vs no-compression: {trainer.comm_savings():.2%}")
    if args.wire != "raw" and trainer.bytes_wire_raw:
        say(f"wire coding ({args.wire}): {trainer.bytes_synced}/"
            f"{trainer.bytes_wire_raw} coded/raw payload bytes "
            f"({trainer.bytes_synced / trainer.bytes_wire_raw:.2%})")
    if args.trace and trainer._writer:
        S, M = args.pipe, (args.micro or args.pipe)
        sim = simulate_schedule(args.schedule, S, M)
        # scale the unit-tick spans so the trace's makespan matches the
        # measured mean step wall time (first -> last history record)
        if len(hist) >= 2 and hist[-1]["step"] > hist[0]["step"]:
            mean_step_s = ((hist[-1]["wall_s"] - hist[0]["wall_s"])
                           / (hist[-1]["step"] - hist[0]["step"]))
        else:
            mean_step_s = float(sim["makespan"])
        scale = mean_step_s / float(sim["makespan"])
        events = tick_trace_events(
            args.schedule, S, M, t_f=scale, t_b=scale,
            sync_plan=trainer.overlap_plan, stash_policy=args.stash,
            n_units=trainer._part.num_units(), stash_every=args.stash_every,
            time_unit_us=1e6)
        write_chrome_trace(args.trace, events, metadata={
            "arch": cfg.name, "schedule": args.schedule, "S": S, "M": M,
            "mean_step_s": mean_step_s})
        summary = validate_trace(load_trace(args.trace))
        say(f"trace: {args.trace} — {summary['spans']} spans on "
            f"{summary['tracks']} stage tracks, "
            f"{summary['end_us']/1e6:.3f}s span horizon")
    trainer.metrics.close()
    if trainer.recovery is not None:
        say(f"recovery: {trainer.recovery.as_dict()}")
    if args.out and trainer._writer:
        with open(args.out, "w") as f:
            json.dump({"history": hist, "arch": cfg.name,
                       "policy": args.policy,
                       "comm_savings": trainer.comm_savings()}, f, indent=1)
    if mesh is not None:
        dist.destroy_process_group()
    return hist


def _elastic(args, cfg, model, edgc, tcfg) -> list[dict]:
    """The elastic outer loop: ``--pods`` pod trainers on one device, each
    on its own data (seeded ``seed + 1000 * pod``)."""
    from repro_torch.optim.outer import OuterConfig
    from repro_torch.train.elastic import ElasticTrainer
    from repro_torch.train.trainer import resolve_device

    def pod_batches(pod: int):
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           batch_size=args.batch, seed=args.seed + 1000 * pod)
        for b in data.batches():
            yield add_modality_stubs(b, cfg.family,
                                     audio_frames=cfg.audio_frames,
                                     num_patches=cfg.num_patches,
                                     d_model=cfg.d_model, seed=args.seed)

    ocfg = OuterConfig(outer_k=args.outer_k, lr=args.outer_lr,
                       momentum=args.outer_momentum, policy=args.outer_policy,
                       fixed_rank=args.outer_rank, window=args.outer_window,
                       total_rounds=args.rounds)
    device = resolve_device(args.device)
    et = ElasticTrainer(model, edgc, tcfg, ocfg, args.pods, pod_batches,
                        seed=args.seed, devices=[device] * args.pods)
    print(f"{cfg.name}: elastic outer loop, {args.pods} pods x "
          f"K={args.outer_k} inner steps on {device}, outer policy="
          f"{args.outer_policy}, {args.rounds} rounds"
          + (f", inject={args.inject}" if args.inject else ""))
    with profiler_session(bool(args.profile), args.profile or "profile"):
        hist = et.run_rounds(args.rounds)
    et.metrics.close()
    for h in hist:
        ev = f" {h['membership_events']}" if h["membership_events"] else ""
        losses = "/".join(f"{x:.3f}" for x in h["pod_losses"])
        print(f"round {h['round']:4d} pods {h['n_pods']} "
              f"loss {losses} H {h['entropy']:+.3f} "
              f"outer-bytes {h['bytes_synced']}/{h['bytes_full']}{ev}")
    print(f"outer comm savings vs raw fp32: {et.outer.comm_savings():.2%}")
    if et.pods[0].recovery is not None:
        print(f"recovery: {et.pods[0].recovery.as_dict()}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"history": hist, "arch": cfg.name,
                       "outer": dataclasses.asdict(ocfg),
                       "comm_savings": et.outer.comm_savings()}, f, indent=1)
    return hist


def _process_mesh(args):
    """The process mesh of a world of several processes (None alone): the
    default group from the environment ``torch.distributed.run`` sets, gloo
    on the CPU, NCCL with one card per process."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    model = args.model_mesh
    if world == 1 and args.data_mesh == 1 and not model:
        return None          # every stage in this process (LocalPipe)
    # one process with a model axis keeps every stage (LocalPipe) on a
    # (data 1, model 1) mesh; a world of several hosts one stage each
    pipe = 0 if world == 1 else args.pipe
    if world != max(1, pipe) * args.data_mesh * max(1, model):
        need = max(1, args.pipe) * args.data_mesh * max(1, model)
        raise SystemExit(f"--pipe {args.pipe} --data-mesh {args.data_mesh} "
                         f"--model-mesh {model} needs {need} processes, the "
                         f"world has {world}")
    if model and args.outer_k:
        raise SystemExit("--model-mesh beside --outer-k: the reference's "
                         "pods each run on a 1x1 (data, model) mesh")
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if not cpu:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
    if not dist.is_initialized():
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group("gloo" if cpu else "nccl")
        else:                # one process started without the launcher
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            dist.init_process_group(
                "gloo" if cpu else "nccl",
                init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    return make_host_mesh(pipe=pipe, data=args.data_mesh, model=model,
                          device_type="cpu" if cpu else "cuda")


if __name__ == "__main__":
    main()
