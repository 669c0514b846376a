"""Split a cell's training step by the program's spans, on the card.

    python3 bench/phases.py --workload gpt2-2.5b.flat.none --seed 12345 \\
        --seconds 10

Builds the cell as ``run.py`` does (``harness.Run``: weights and batches
from the seed, the trainer, its first steps and the steps that time one
step), then, in one process:

* four windows of ``round(seconds / step)`` steps, each one
  ``Trainer.run`` call ending on a synchronise, with the program's spans
  off, on, on, off (on, off, off, on for an even seed;
  ``repro_torch.obs.trace.record_spans`` around the on windows): tokens a
  second with the recorder and without; and the host's microseconds of
  one empty span, recording off and on;
* a one-step profiler session to start the profiler up, then
  ``harness.TRACE_STEPS`` steps under ``torch.profiler`` (CUDA activity
  only, as ``Run.traced``), without spans and with them, in the windows'
  first two modes' order, each after
  untraced steps that keep a gated step and a flush out of it: the idle
  share and launches a step of each, and for the second the attribution
  of ``bench.spans``: device busy and idle time by span (``by_span``), the
  device ms a step of ``step.forward``, ``step.backward``,
  ``step.optimizer`` and ``step.sync``, the host's ms to queue a step
  (``host.issue_ms``), each top device op split by span, and the largest
  idle gaps with their spans.

The last line of standard output is one JSON object. Needs CUDA; the
output comparison of ``run.py`` is not made here.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]
from bench import run as _run  # noqa: E402,F401  (the checkout's build caches)


def traced(run, spans_on: bool, steps: int) -> dict:
    """``steps`` steps under the profiler, as ``Run.traced`` runs them;
    returns the trace's events, its base time and the spans."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.trace import record_spans
    run.sync()
    acts = [ProfilerActivity.CUDA] if run.cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        with record_spans() if spans_on else contextlib.nullcontext([]) as spans:
            run.trainer.run(run.feed, num_steps=steps)
        run.sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            obj = json.load(f)
    return {"events": obj["traceEvents"], "base_ns": obj.get("baseTimeNanoseconds"),
            "spans": spans}


def align(run, steps: int) -> int:
    """Untraced steps until the next ``steps`` steps hold no gated step and
    no flush, so that two traced runs trace alike steps; returns how many."""
    tr = run.trainer

    def marked(s):
        return (tr.controller.wants_entropy(s) or s % tr.tcfg.log_every == 0
                or (s + 1) % tr.edgc_cfg.dac.window == 0)
    n = 0
    while n < 100 and any(marked(tr._global_step + i) for i in range(steps)):
        tr.run(run.feed, num_steps=1)
        n += 1
    return n


def span_cost_us(n: int = 100_000) -> dict:
    """Host microseconds of one ``with span(...)`` block with nothing in it,
    recording off and on."""
    from repro_torch.obs.trace import record_spans, span

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("x"):
                pass
        return (time.perf_counter() - t0) / n * 1e6
    off = loop()
    with record_spans():
        on = loop()
    return {"off": off, "on": on}


def measure(name: str, seed: int, seconds: float, device=None, root=None) -> dict:
    """The windows and the two traced runs of cell ``name`` (module
    docstring), as one dict."""
    import torch
    from bench import catalog, harness, spans as bench_spans, trace
    from repro_torch.obs.trace import record_spans
    c = catalog.cell(name, root or catalog.BENCH)
    if c.layout.processes(c.mix) != 1:
        raise SystemExit("bench: phases.py runs one-process cells only")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    run = harness.Run(c, seed, device, use_kernels=torch.device(device).type == "cuda")
    run.setup()
    run.first_steps()
    t_step = run.time_step()
    steps = max(2, round(seconds / t_step))
    tokens = c.mix["batch"] * c.mix["seq"]
    rates: dict[str, list[float]] = {"off": [], "on": []}
    # off, on, on, off on odd seeds and on, off, off, on on even ones: the
    # card's clock drifts over the four windows, and the step cadence (the
    # gate, flushes) puts different steps in each
    order = ("off", "on", "on", "off") if seed % 2 else ("on", "off", "off", "on")
    for mode in order:
        if mode == "on":
            with record_spans() as spans:
                win = run.window(steps)
            if len(spans) < 6 * steps:
                raise AssertionError(f"{len(spans)} spans in {steps} steps")
        else:
            win = run.window(steps)
        rates[mode].append(steps * tokens / win["wall"])
        harness.say(f"bench: window spans {mode}: {rates[mode][-1]:.1f} tokens/s")
    out = {"workload": name, "seed": seed, "window_steps": steps,
           "device": torch.cuda.get_device_name(run.device) if run.cuda else "cpu",
           "torch": torch.__version__,
           "tokens_per_s_off": statistics.mean(rates["off"]),
           "tokens_per_s_on": statistics.mean(rates["on"]),
           "windows": rates, "window_order": order, "span_us": span_cost_us()}
    traced(run, False, 1)       # the profiler's first session starts slow
    for mode in order[:2]:
        out[f"aligned_{mode}"] = align(run, harness.TRACE_STEPS)
        got = traced(run, mode == "on", harness.TRACE_STEPS)
        cap = trace.from_events(got["events"], None, harness.TRACE_STEPS)
        busy = trace.busy_us(cap)
        row = {"idle_share": 100.0 * (1.0 - busy / cap.window_us) if cap.window_us else None,
               "launches_per_step": cap.launches / cap.steps, "kernels": len(cap.kernels),
               "kernel_s": sum(k.end - k.start for k in cap.kernels) / 1e6,
               "busy_s": busy / 1e6, "window_s": cap.window_us / 1e6,
               "base_ns": got["base_ns"], "idle_gaps": trace.idle_gaps(cap, 5)}
        if mode == "on":
            if got["base_ns"] is None:
                raise SystemExit("bench: the trace has no baseTimeNanoseconds")
            att = bench_spans.attribute(got["events"], got["spans"], int(got["base_ns"]),
                                        harness.TRACE_STEPS)
            row.update(bench_spans.summary(att, got["spans"]))
            row["busy_sum_s"] = att.busy_us / 1e6
            row["spans"] = [[s.name, s.step, (s.end_ns - s.start_ns) / 1e6]
                            for s in got["spans"]]
        out[f"traced_{mode}"] = row
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench: CUDA is not available")
    print(json.dumps(measure(args.workload, args.seed, args.seconds)), flush=True)


if __name__ == "__main__":
    main()
