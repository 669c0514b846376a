#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py                       # all phases, one card
    python3 chip_smoke.py --out chip_smoke.json --profile

Phases, in order; any failure raises, so the exit code is not 0:

  (a) build    compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
  (b) kernels  each PowerSGD kernel against its plain PyTorch version on
               the main path's shape groups (and a ragged shape, and bf16),
               with kernel, plain, library-call and bound times
  (c) main     ``Trainer.run`` for 4 steps on gpt2-2.5b at its published
               widths (depth cut to 8 layers, 2 per stage), policy fixed,
               rank 64, kernels on, bucketed, batch 8 x seq 1024, bf16
  (d) control  policy edgc, 12 steps, window 4, depth 4: the DAC window
               re-plan and the stacked-state resize, kernels on
  (e) check    a small fp32 model trained 3 steps on the card through the
               kernels agrees with the same run on the CPU (plain versions)

The line before the card's line is ``{"kernels": [...]}``: one entry per
kernel, its numbers summed over the main path's three shape groups (one
step's work for that kernel). The last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits 2 and
prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
MAIN_GROUPS = [(32, 1920, 1920, 64), (8, 1920, 7680, 64), (8, 7680, 1920, 64)]
RAGGED = (3, 1000, 1030, 40)
REPLACES = {
    "lowrank_p": "src/repro/kernels/lowrank.py:188",
    "lowrank_q": "src/repro/kernels/lowrank.py:218",
    "decompress_residual": "src/repro/kernels/lowrank.py:247",
    "gram_schmidt": "src/repro/kernels/lowrank.py:288",
}
SOURCE = "src/repro_torch/kernels/csrc/lowrank.cu"
# Kernel against plain version, as max|kernel - plain| / max|plain|. fp32
# products sum in another order than cuBLAS (about 1e-7 relative); bf16
# outputs of decompress round once (2**-8 relative).
TOL = {"float32": 1e-5, "bfloat16": 1e-2, "gram_schmidt": 1e-4}


def log(*args) -> None:
    print(*args, flush=True)


def _import_port():
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    src = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in src.parents:
        raise RuntimeError(f"repro_torch imported from {src}, not this checkout")


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-30)


# ------------------------------------------------------------------ (a) build
def phase_build(report: dict) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    report["build"] = {"seconds": secs, "logs": logs}
    log(f"(a) build: {secs:.2f} s ({', '.join(build.SOURCES)}) -> {build.BUILD_DIR}")
    for text in logs.values():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("    ptxas:", line.strip())


# ---------------------------------------------------------------- (b) kernels
def _cases(e, m, n, r, dtype, dev):
    """The four kernels at one (E, m, n, r): kernel, plain and library calls,
    bytes and operations, and how to compare."""
    from repro_torch.kernels import lowrank as lr, ref
    gen = torch.Generator(device=dev).manual_seed(e * 7 + m + n + r)
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)
    g = rand(e, m, n).to(dtype)
    err = (0.1 * rand(e, m, n)).to(dtype)
    q = rand(e, n, r)
    p_hat = torch.linalg.qr(rand(e, m, r))[0]
    panel = rand(e, m, r)
    isz = g.element_size()
    mn = e * m * n
    return {
        "lowrank_p": dict(
            kernel=lambda: lr.ef_lowrank_p(g, err, q),
            plain=lambda: ref.ef_lowrank_p(g, err, q),
            library=lambda: torch.bmm(g.float() + err.float(), q),
            nbytes=2 * mn * isz + 4 * e * (n * r + m * r),
            flops=mn + 2 * mn * r, tol=TOL["float32"]),
        "lowrank_q": dict(
            kernel=lambda: lr.ef_lowrank_q(g, err, p_hat),
            plain=lambda: ref.ef_lowrank_q(g, err, p_hat),
            library=lambda: torch.bmm((g.float() + err.float()).mT, p_hat),
            nbytes=2 * mn * isz + 4 * e * (m * r + n * r),
            flops=mn + 2 * mn * r, tol=TOL["float32"]),
        "decompress_residual": dict(
            kernel=lambda: lr.decompress_residual(p_hat, q, g, err),
            plain=lambda: tuple(t.to(dtype) for t in
                                ref.decompress_residual(p_hat, q, g, err)),
            library=lambda: _library_decompress(p_hat, q, g, err),
            nbytes=4 * mn * isz + 4 * e * (m * r + n * r),
            flops=2 * mn * r + 2 * mn,
            tol=TOL["float32"] if dtype == torch.float32 else TOL["bfloat16"]),
        "gram_schmidt": dict(
            kernel=lambda: lr.gram_schmidt_panel(panel),
            plain=lambda: lr.plain_gram_schmidt(panel),
            library=lambda: torch.linalg.qr(panel)[0],
            nbytes=2 * 4 * e * m * r,
            flops=e * (2 * m * r * (r - 1) + 3 * m * r), tol=TOL["gram_schmidt"]),
    }


def _library_decompress(p_hat, q, g, err):
    g_hat = torch.bmm(p_hat, q.mT)
    return g_hat.to(g.dtype), (g.float() + err.float() - g_hat).to(g.dtype)


def _check_orthonormal(u: torch.Tensor, plain: torch.Tensor) -> None:
    eye = torch.eye(u.shape[-1], device=u.device)
    gram = (u.mT @ u - eye).abs().max().item()
    span = ((u.mT @ plain).abs() - eye).abs().max().item()
    if gram > 2e-4 or span > 2e-3:
        raise AssertionError(f"gram_schmidt: |U^T U - I| = {gram:.2e} (2e-4), "
                             f"|U^T U_plain| - I = {span:.2e} (2e-3)")


def phase_kernels(report: dict, dev) -> None:
    rows = []
    shapes = [(s, torch.float32, True) for s in MAIN_GROUPS]
    shapes += [(RAGGED, torch.float32, False), (RAGGED, torch.bfloat16, False)]
    for (e, m, n, r), dtype, main in shapes:
        cases = _cases(e, m, n, r, dtype, dev)
        for name, c in cases.items():
            got, want = c["kernel"](), c["plain"]()
            torch.cuda.synchronize()
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            abs_err, rel = max((rel_err(a, b) for a, b in pairs),
                               key=lambda t: t[1])
            if name == "gram_schmidt":
                _check_orthonormal(got, want)
            if not rel <= c["tol"]:
                raise AssertionError(f"{name} {(e, m, n, r)} {dtype}: error "
                                     f"{rel:.3e} relative > {c['tol']:.0e}")
            slow = name == "gram_schmidt"
            row = dict(kernel=name, shape=[e, m, n, r], dtype=str(dtype)[6:],
                       main_path=main, max_abs_err=abs_err, rel_err=rel,
                       tol=c["tol"],
                       ms=time_ms(c["kernel"], 20),
                       plain_ms=time_ms(c["plain"], 3 if slow else 10),
                       library_ms=time_ms(c["library"], 3 if slow else 10))
            row["bound_ms"], row["bound_by"] = bound_ms(c["nbytes"], c["flops"])
            rows.append(row)
            log(f"(b) {name:20s} E,m,n,r={e},{m},{n},{r} {row['dtype']:8s} "
                f"err {abs_err:.2e} abs {rel:.2e} rel (tol {c['tol']:.0e}) | "
                f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} "
                f"library {row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
                f"ms ({row['bound_by']})")
        del cases
        torch.cuda.empty_cache()
    report["kernel_rows"] = rows


# ------------------------------------------------------------------ trainers
def _trainer(model_cfg, policy, rank, steps, window, dev):
    """A Trainer with the PowerSGD kernels on, AdamW at lr 1e-3."""
    from repro_torch.core import EDGCConfig, GDSConfig
    from repro_torch.core.dac import DACConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    edgc = EDGCConfig(policy=policy, fixed_rank=rank, total_iterations=steps,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=window, adjust_limit=4),
                      num_stages=model_cfg.num_stages, use_kernels=True)
    tcfg = TrainerConfig(total_steps=steps, log_every=1, use_kernels=True,
                         adam=AdamConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=steps))
    return Trainer(build_model(model_cfg), edgc, tcfg, seed=0, device=dev)


def _timed_steps(trainer, batches, steps: int) -> list[float]:
    """Host ms of each step, each ending in a device synchronise."""
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(batches, num_steps=1)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def phase_check(report: dict, dev) -> None:
    """Small fp32 model: the kernel path on the card against the CPU."""
    from repro_torch.configs.gpt2 import GPT2_FIDELITY
    from repro_torch.data.pipeline import SyntheticLM
    losses = {}
    for where in ("cpu", dev):
        tr = _trainer(GPT2_FIDELITY, "fixed", 8, 3, 50, where)
        hist = tr.run(SyntheticLM(GPT2_FIDELITY.vocab_size, 64, 4, seed=1).batches())
        losses[str(where)] = [h["loss"] for h in hist]
    cpu, gpu = losses["cpu"], losses[str(dev)]
    gap = max(abs(a - b) for a, b in zip(cpu, gpu))
    report["check"] = {"cpu_loss": cpu, "gpu_loss": gpu, "max_gap": gap}
    log(f"(e) check gpt2-fidelity fp32, 3 steps: card {gpu} cpu {cpu} "
        f"max gap {gap:.2e} (tol 5e-3)")
    if not gap < 5e-3 or not all(math.isfinite(x) for x in gpu):
        raise AssertionError("the card's kernel path disagrees with the CPU")


def phase_main(report: dict, dev, profile: bool) -> dict:
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import lowrank as lr
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=8)
    tr = _trainer(cfg, "fixed", 64, 5, 50, dev)    # step 5: --profile
    groups = [(g.stack_size, g.m, g.n, g.rank) for g in tr._layout.groups]
    log(f"(c) main: {cfg.name} depth {cfg.num_layers} d_model {cfg.d_model} "
        f"heads {cfg.num_heads} d_ff {cfg.d_ff} vocab {cfg.vocab_size} "
        f"{cfg.dtype} remat={cfg.remat}: {tr.n_params / 1e9:.3f} B params; "
        f"shape groups (E,m,n,r) {groups}")
    if sorted(groups) != sorted(MAIN_GROUPS):
        raise AssertionError(f"main-path groups {groups} != {MAIN_GROUPS}")
    batches = SyntheticLM(cfg.vocab_size, 1024, 8, seed=0).batches()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in lr.KERNELS:
        k.launches = 0
    step_ms = _timed_steps(tr, batches, 4)
    launches = {k.__name__: k.launches for k in lr.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in tr.history]
    report["main"] = {"loss": losses, "step_ms": step_ms, "peak_bytes": peak,
                      "launches": launches, "groups": groups,
                      "n_params": tr.n_params}
    for h, ms in zip(tr.history, step_ms):
        log(f"    step {h['step']} loss {h['loss']:.4f} {ms:.1f} ms "
            f"bytes synced {h['bytes_synced']}")
    log(f"    peak memory {peak / 2**30:.2f} GiB; launches {launches}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != 4:
        raise AssertionError(f"main-path losses {losses}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    if profile:
        report["profile"] = profile_step(tr, batches, sorted(step_ms[1:])[1])
    return launches


def profile_step(trainer, batches, step_ms: float, top: int = 25) -> dict:
    """One more main-path step under torch.profiler: device time by kernel,
    and the device's idle share of an unprofiled step of ``step_ms`` (the
    profiler's own host cost stretches the profiled step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run(batches, num_steps=1)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in rows)
    log(f"    profiled step: {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms; "
        f"idle share of a {step_ms:.1f} ms unprofiled step "
        f"{1 - busy_ms / step_ms:.3f}")
    for key, ms, count in rows[:top]:
        log(f"      {ms:9.3f} ms {count:6d}x  {key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "step_ms": step_ms,
            "by_kernel": [{"name": k, "ms": ms, "count": c} for k, ms, c in rows]}


def phase_control(report: dict, dev) -> None:
    from repro_torch.configs.gpt2 import GPT2_2_5B
    from repro_torch.data.pipeline import SyntheticLM
    cfg = dataclasses.replace(GPT2_2_5B, num_layers=4)
    tr = _trainer(cfg, "edgc", 64, 12, 4, dev)
    t0 = time.perf_counter()
    hist = tr.run(SyntheticLM(cfg.vocab_size, 1024, 8, seed=0).batches())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ranks = [h["ranks"] for h in hist]
    report["control"] = {"ranks": ranks, "loss": [h["loss"] for h in hist],
                         "seconds": secs, "comm_savings": tr.comm_savings(),
                         "plan": tr.controller.describe()}
    log(f"(d) control: edgc 12 steps window 4 depth 4 in {secs:.1f} s; ranks "
        f"{ranks}; comm savings {tr.comm_savings():.4f}")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError("control-plane run gave a non-finite loss")
    if not ranks[-1]:
        raise AssertionError("the DAC never left warm-up in 12 steps")


# ----------------------------------------------------------------- the lines
def kernels_line(report: dict, launches: dict) -> dict:
    names = {"lowrank_p": "ef_lowrank_p", "lowrank_q": "ef_lowrank_q",
             "decompress_residual": "decompress_residual",
             "gram_schmidt": "gram_schmidt_panel"}
    out = []
    for name, wrapper in names.items():
        rows = [r for r in report["kernel_rows"]
                if r["kernel"] == name and r["main_path"]]
        total = lambda key: sum(r[key] for r in rows)
        bound_by = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
        out.append({"name": name, "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES[name], "launches": launches[wrapper],
                    "max_abs_err": max(r["max_abs_err"] for r in report["kernel_rows"]
                                       if r["kernel"] == name),
                    "ms": total("ms"), "plain_ms": total("plain_ms"),
                    "bound_ms": total("bound_ms"), "bound_by": bound_by,
                    "library_ms": total("library_ms")})
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more main-path step (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's kernels need an NVIDIA "
              "Hopper card", file=sys.stderr)
        return 2
    _import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({smi})")
    report: dict = {"card": smi, "torch": torch.__version__}
    t0 = time.perf_counter()
    phase_build(report)
    phase_kernels(report, dev)
    launches = phase_main(report, dev, args.profile)
    phase_control(report, dev)
    phase_check(report, dev)
    report["seconds"] = time.perf_counter() - t0
    line = kernels_line(report, launches)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**report, **line}, indent=1))
    log(f"all phases passed in {report['seconds']:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
