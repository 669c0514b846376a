"""One run of one cell: set-up, the first steps that the output check
reads, the measured window, the traced window, the reference, the result.

Set-up builds one trainer (the port's ``Trainer``, through the cell's
layout) on weights and a pool of batches made on the device from the
seed. Its first three steps go through ``Trainer.run`` and the window's
feed: the check reads each step's loss, the entropy of the gated step
0, the first gradient as AdamW holds it after step 1 (its first moment
over 1 - beta1) and each unit's change after step 3. Three more steps
time a step; the window is then ``round(seconds / step)`` steps in one
``Trainer.run`` call, ending on a device synchronise. With ``trace`` three
more steps run under ``torch.profiler``. Once the window has closed and
the peak memory is read, the program's state is freed and the plain
reference runs the first three steps again on the same weights and rows.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import os
import statistics
import sys
import tempfile
import time

import torch

from bench import catalog, flops, synth, trace, weights
from bench.reference import train as ref_train

CHECK_STEPS = 3          # the steps the reference follows
TIME_STEPS = 3           # steps that time one step before the window
TRACE_STEPS = 3          # steps under the profiler
#: the JAX package and its stack, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the line a process says once its first steps are done (a launcher of
#: several processes watches for it)
FIRST_STEPS_DONE = "bench: first steps done"


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except OSError:
        return 0.0


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Record:
    """What a run measured; the per-layer metric readers take it."""

    model: dict
    mix: dict
    chips: int
    world: int
    window_steps: int
    window_s: float
    tokens_per_step: int           # over every replica
    step_ms: list                  # device-timeline step intervals in the window
    sync_bytes_per_step: float
    groups: list
    param_bytes: int
    captured: trace.Captured | None = None


class Feed:
    """The batches ``Trainer.run`` takes: the pool in turn. While
    ``events`` is a list, each batch taken records a CUDA event on the
    current stream (no synchronise)."""

    def __init__(self, pool: list[dict]) -> None:
        self.pool, self.taken, self.events = pool, 0, None

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self.pool[self.taken % len(self.pool)]
        self.taken += 1
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        return b


def make_trainer(model, m: dict, mix: dict, seed: int, device,
                 use_kernels: bool, pipe=None, mesh=None, pipeline=None):
    """The port's ``Trainer`` for a cell: ``fixed`` (or the mix's) policy
    at the mix's rank, the GDS gate and DAC window, AdamW as the mix says."""
    from repro_torch.core import EDGCConfig, GDSConfig
    from repro_torch.core.dac import DACConfig
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    a = mix["adam"]
    edgc = EDGCConfig(policy=mix["policy"], fixed_rank=mix["rank"],
                      total_iterations=a["total_steps"],
                      gds=GDSConfig(alpha=mix["gds"]["alpha"], beta=mix["gds"]["beta"]),
                      dac=DACConfig(window=mix["dac"]["window"],
                                    adjust_limit=mix["dac"]["adjust_limit"]),
                      num_stages=m["num_stages"], use_kernels=use_kernels,
                      wire=mix["wire"])
    tcfg = TrainerConfig(total_steps=a["total_steps"], log_every=mix["log_every"],
                         use_kernels=use_kernels, wire=mix["wire"],
                         adam=AdamConfig(lr=a["lr"], betas=tuple(a["betas"]),
                                         eps=a["eps"], weight_decay=a["weight_decay"],
                                         grad_clip=a["grad_clip"],
                                         warmup_steps=a["warmup_steps"],
                                         total_steps=a["total_steps"],
                                         min_lr_frac=a["min_lr_frac"]),
                         **(pipeline or {}))
    return Trainer(model, edgc, tcfg, seed=seed, device=device, pipe=pipe, mesh=mesh)


def build_model(m: dict, params: dict):
    """The port's model for the configuration, whose ``init`` hands over
    ``params`` (once: the trainer then owns them)."""
    from repro_torch.models.model import ModelConfig, build_model as port_build
    held = [params]
    model = port_build(ModelConfig(**m))
    return model._replace(init=lambda seed, device: held.pop())


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield tree


def nonfinite_leaves(state) -> int:
    """How many floating tensors of the trainer's state (weights, moments,
    compressor state) hold a NaN or an infinity: a training run that has
    diverged inside the window."""
    flags = [~torch.isfinite(t).all() for t in _tensors(state)]
    return int(torch.stack(flags).sum()) if flags else 0


def _norms(units: dict, scale: float = 1.0) -> dict[str, float]:
    names = list(units)
    vals = torch.stack([torch.linalg.vector_norm(units[k].float()) for k in names])
    return {k: float(v) * scale for k, v in zip(names, vals.tolist())}


def unit_gaps(prog: dict, ref: dict, key: str, keep=None) -> dict[str, float]:
    """Per unit, the gap between the program's and the reference's norms
    over the reference's norm of that unit or of the median unit, the
    larger (a non-finite norm reads inf)."""
    keep = list(ref[key]) if keep is None else keep
    med = statistics.median(ref[key][k] for k in keep)
    return {k: (abs(prog[key][k] - ref[key][k]) if math.isfinite(prog[key][k]) else math.inf)
            / max(ref[key][k], med, 1e-30) for k in keep}


def moved_units(ref: dict) -> list[str]:
    """Units whose reference gradient is at least a thousandth of the
    median unit's: the others (a key's bias under softmax) move under
    AdamW by round-off alone."""
    g_med = statistics.median(ref["grad_norm"].values())
    return [k for k, g in ref["grad_norm"].items() if g >= 1e-3 * g_med]


def readings(prog: dict, ref: dict) -> dict:
    """Every number read from the first steps: each step's loss gap (nats,
    the largest), the entropy gap of the gated steps (nats), the first
    gradient's norm gap as AdamW got it by the worst unit, and the change's
    norm gap over the steps by the median and by the worst unit."""
    out = {"loss_gap": max(abs(a - b) if math.isfinite(a) else math.inf
                           for a, b in zip(prog["loss"], ref["loss"])),
           "entropy_gap": max((abs(prog["entropy"][t] - h)
                               if math.isfinite(prog["entropy"][t]) else math.inf)
                              for t, h in ref["entropy"].items()),
           "grad_norm_gap": max(unit_gaps(prog, ref, "grad_norm").values())}
    change = list(unit_gaps(prog, ref, "change_norm", moved_units(ref)).values())
    out["change_gap"] = statistics.median(change)
    out["change_gap_worst"] = max(change)
    return out


def compare(prog: dict, ref: dict, limits: dict, nonfinite: int = 0) -> dict:
    """The numbers the cell's limits name (``limits/<cell>.json``), each
    beside its limit, and, with the limit 0, the tensors of the state the
    window left that are not finite."""
    got = readings(prog, ref)
    out = {k: {"value": got[k], "limit": v} for k, v in limits.items()}
    out["window_nonfinite_tensors"] = {"value": nonfinite, "limit": 0}
    return out


class Run:
    """One process's part of one run of a cell (rank ``rank`` of ``world``)."""

    def __init__(self, cell: catalog.Cell, seed: int, device, use_kernels: bool = True,
                 rank: int = 0, world: int = 1, fault=None, t_start=None) -> None:
        self.c, self.seed = cell, seed
        self.device, self.use_kernels = torch.device(device), use_kernels
        self.rank, self.world, self.fault = rank, world, fault
        self.t_start = t_start if t_start is not None else time.time() - process_age()
        self.m, self.mix = cell.model, cell.mix
        self.cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- set-up
    def mark(self, what: str) -> None:
        self.sync()
        say(f"bench: {what} at {time.time() - self.t_start:.2f} s")

    def setup(self) -> None:
        m, mix = self.m, self.mix
        self.mark("set-up starts")
        params = weights.make(m, self.seed, self.device)
        self.pool = synth.pool(m["vocab_size"], mix, self.seed, self.device)
        self.mark("weights and batches made")
        self.feed = Feed(self.pool)
        self.trainer = self.c.layout.build(self, build_model(m, params), m, mix)
        del params
        self.mark("trainer built")
        if self.fault is not None:
            self.fault(self)

    def first_steps(self) -> dict:
        """The program's outputs of the first steps, for the check."""
        tr, b1 = self.trainer, self.mix["adam"]["betas"][0]
        layout = self.c.layout
        tr.tcfg.log_every = 1          # every one of these steps is read
        tr.run(self.feed, num_steps=1)
        self.mark("first step done")
        out = {"grad_norm": _norms(layout.units(tr, self.m, "opt_m"), 1.0 / (1 - b1))}
        tr.run(self.feed, num_steps=CHECK_STEPS - 1)
        hist = tr.history[-CHECK_STEPS:]
        out["loss"] = [float(h["loss"]) for h in hist]
        out["entropy"] = {i: float(h["entropy"]) for i, h in enumerate(hist)}
        self.after = ({k: v.detach().to("cpu", copy=True)
                       for k, v in layout.units(tr, self.m, "params").items()}
                      if self.rank == 0 else None)
        tr.tcfg.log_every = self.mix["log_every"]
        return out

    def time_step(self) -> float:
        self.sync()
        if self.world > 1:
            # every process starts the clock together (rank 0 has copied
            # the weights to the host after its first steps)
            import torch.distributed as dist
            dist.barrier()
        t0 = time.perf_counter()
        self.trainer.run(self.feed, num_steps=TIME_STEPS)
        self.sync()
        return (time.perf_counter() - t0) / TIME_STEPS

    # ----------------------------------------------------------- window
    def window(self, steps: int) -> dict:
        tr = self.trainer
        self.sync()
        b0 = tr.bytes_synced
        self.feed.events = [] if self.cuda else None
        t0 = time.perf_counter()
        tr.run(self.feed, num_steps=steps)
        self.sync()
        wall = time.perf_counter() - t0
        evs, self.feed.events = self.feed.events or [], None
        step_ms = [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
        logged = [h for h in tr.history if h["step"] >= tr._global_step - steps]
        return {"wall": wall, "steps": steps, "step_ms": step_ms,
                "bytes": tr.bytes_synced - b0,
                "failed": sum(1 for h in logged if not math.isfinite(h["loss"])),
                "nonfinite": nonfinite_leaves(tr.state)}

    def traced(self) -> trace.Captured:
        """``TRACE_STEPS`` more steps under ``torch.profiler``, recording the
        device's kernels and the CUDA runtime's calls (not every host op,
        whose recording would slow the host's side of the step); the
        window runs from the first launch to the last kernel's end."""
        import json
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]
        self.sync()
        with profile(activities=acts) as prof:
            self.trainer.run(self.feed, num_steps=TRACE_STEPS)
            self.sync()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"trace{self.rank}.json")
            prof.export_chrome_trace(path)
            del prof
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return trace.from_events(events, None, TRACE_STEPS)

    # ----------------------------------------------------------- after
    def release(self) -> None:
        self.trainer = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference(self, program: dict) -> dict:
        """The reference's three steps, and the program's change worked out
        against the same starting weights."""
        m, mix = self.m, self.mix
        start = weights.make(m, self.seed, self.device)
        u0 = {k: v.float() for k, v in weights.units_of_flat(m, start).items()}
        del start
        ref = ref_train.run(m, mix, u0, self.pool[:CHECK_STEPS], self.seed,
                            steps=CHECK_STEPS)
        if self.after is not None:
            program["change_norm"] = {
                k: float(torch.linalg.vector_norm(v.to(self.device).float() - u0[k]))
                for k, v in self.after.items()}
        return ref


def _metric_values(spec: dict, c: catalog.Cell, rec: Record, root) -> dict:
    out = {}
    for name, (entry, mod) in catalog.metric_readers(spec, c.name, root).items():
        v = mod.read(rec)
        if v is not None:
            out[name] = {"value": float(v), "unit": entry["unit"]}
    return out


def _reduce(values: list[float], op: str, run: Run) -> float:
    """``op`` (max, mean) of one number per process of the run."""
    if run.world == 1:
        return values[0]
    import torch.distributed as dist
    t = torch.tensor(values, dtype=torch.float64, device=run.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
    return float(t[0]) / (run.world if op == "mean" else 1)


def execute(name: str, seed: int, seconds: float, trace_on: bool, *,
            device=None, use_kernels: bool = True, fault=None,
            root=catalog.BENCH, repo=catalog.REPO, rank: int = 0, world: int = 1,
            t_start=None, control=None) -> dict | None:
    """One run of cell ``name`` in this process (rank ``rank`` of
    ``world``, the process group already made). Returns the result on
    rank 0 and None elsewhere."""
    spec = catalog.benchmark(repo)
    c = catalog.cell(name, root)
    if device is None:
        device = torch.device("cuda", rank if world > 1 else torch.cuda.current_device())
    run = Run(c, seed, device, use_kernels, rank, world, fault, t_start)
    m, mix = c.model, c.mix
    run.setup()
    prog = run.first_steps()
    say(FIRST_STEPS_DONE)
    t_step = _reduce([run.time_step()], "max", run)
    steps = max(2, round(seconds / t_step))
    setup_s = _reduce([time.time() - run.t_start], "max", run)
    say(f"bench: {name} seed {seed}: set-up {setup_s:.2f} s, a step "
        f"{1e3 * t_step:.1f} ms, window of {steps} steps")
    win = run.window(steps)
    cap = run.traced() if trace_on else None
    peak = torch.cuda.max_memory_allocated(run.device) if run.cuda else 0
    peak = int(_reduce([float(peak)], "max", run))
    busy = window_s = None
    if cap is not None:
        busy = _reduce([trace.busy_us(cap) / 1e6], "mean", run)
        window_s = _reduce([cap.window_us / 1e6], "mean", run)
    run.release()
    if rank != 0:
        return None
    ref = run.reference(prog)
    checks = compare(prog, ref, c.limits, win["nonfinite"])
    if control is not None:
        control.update(program=prog, reference=ref)
    tokens = mix["batch"] * mix["seq"] * mix.get("replicas", 1)
    rec = Record(model=m, mix=mix, chips=c.chips, world=world,
                 window_steps=steps, window_s=win["wall"], tokens_per_step=tokens,
                 step_ms=win["step_ms"], sync_bytes_per_step=win["bytes"] / steps,
                 groups=flops.shape_groups(m, mix["rank"]) if mix["policy"] != "none" else [],
                 param_bytes=torch.empty((), dtype=getattr(torch, m["dtype"])).element_size(),
                 captured=cap)
    if trace_on:
        metrics = _metric_values(spec, c, rec, root)
    else:
        e2e = {"tokens_per_s": (steps * tokens / win["wall"], "tokens/s"),
               "peak_mem_gib": (peak / 2 ** 30, "GiB"),
               "setup_s": (setup_s, "s")}
        metrics = {e["name"]: {"value": e2e[e["name"]][0], "unit": e["unit"]}
                   for e in catalog.end_to_end(spec, name)}
    correct = (all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                   for v in checks.values()) and win["failed"] == 0)
    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if run.cuda else "cpu",
           "count": c.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": steps,
              "failed": max(win["failed"], int(win["nonfinite"] > 0)),
              "metrics": metrics, "device": dev}
    if cap is not None:
        dev["busy_s"], dev["window_s"] = busy, window_s
        result["breakdown"] = {"device_ops": trace.top_ops(cap),
                               "idle_gaps": trace.idle_gaps(cap)}
    result["checks"] = checks
    for k, v in checks.items():
        say(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return result
