"""Run-report CLI: turn a telemetry JSONL stream into a readable summary.

Port of ``repro/launch/report.py``. ``python -m repro_torch.launch.report
RUN_DIR`` (or a metrics.jsonl path) prints what a run did — entropy and
DAC-rank trajectories, wire bytes saved against the uncompressed
baseline, measured step time, and the fault/recovery timeline — from the
records the trainer's ``MetricsRegistry`` emitted:

    python -m repro_torch.launch.report runs/obs_run
    python -m repro_torch.launch.report runs/obs_run --csv m.csv

A pipelined run adds its schedule line and the schedule-ideal bubble
fraction (and an overlap plan's line, where the run has one); ``--trace
PATH`` re-emits a Chrome trace of the run's schedule with its ticks scaled
to the measured step time:

    python -m repro_torch.launch.report runs/pipe --trace runs/pipe/trace.json
"""
from __future__ import annotations

import argparse
import os

from repro_torch.obs.metrics import read_jsonl, write_csv
from repro_torch.obs.trace import (tick_trace_events, validate_trace,
                                   write_chrome_trace)
from repro_torch.pipeline.schedule import bubble_fraction, simulate_schedule

__all__ = ["build_report", "main"]


def _find_jsonl(path: str) -> str:
    if os.path.isdir(path):
        cand = os.path.join(path, "metrics.jsonl")
        if not os.path.exists(cand):
            raise SystemExit(f"no metrics.jsonl in {path}")
        return cand
    return path


def _traj(pairs: list[tuple[int, float]]) -> str:
    """first -> last (min/max over the run) for a scalar trajectory."""
    vals = [v for _, v in pairs]
    return (f"{vals[0]:.4g} -> {vals[-1]:.4g}  "
            f"(min {min(vals):.4g}, max {max(vals):.4g}, n={len(vals)})")


def _scalars(records: list[dict], name: str) -> list[tuple[int, float]]:
    return [(r["step"], r["value"]) for r in records
            if r.get("kind") == "scalar" and r.get("name") == name]


def _series(records: list[dict], name: str) -> list[tuple[int, list]]:
    return [(r["step"], r["values"]) for r in records
            if r.get("kind") == "series" and r.get("name") == name]


def _events(records: list[dict], name: str | None = None) -> list[dict]:
    return [r for r in records if r.get("kind") == "event"
            and (name is None or r.get("name") == name)]


def build_report(records: list[dict]) -> list[str]:
    """Render the text report as a list of lines (testable without I/O)."""
    lines: list[str] = []
    meta = next((e for e in _events(records, "run_meta")), None)
    if meta is not None:
        d = meta.get("data", {})
        lines.append(f"run: {d.get('model')} ({d.get('family')}) "
                     f"policy={d.get('policy')} world={d.get('world')} "
                     f"steps={d.get('total_steps')}")
        if d.get("pipelined"):
            S, M = d.get("num_stages"), d.get("num_microbatches")
            lines.append(f"pipeline: S={S} M={M} {d.get('schedule')} "
                         f"stash={d.get('stash_policy')} "
                         f"overlap_sync={d.get('overlap_sync')}")
            try:
                lines.append(
                    f"bubble fraction: {bubble_fraction(S, M):.3f} "
                    f"((S-1)/(M+S-1), schedule-ideal)")
            except Exception:
                pass
    plan = next((e for e in _events(records, "overlap_plan")), None)
    if plan is not None:
        d = plan.get("data", {})
        # the reference's keys, which its trainer (and this one) does not
        # write: the line prints None as the reference's does
        lines.append(f"overlap plan: in-loop {d.get('in_loop_chunks')} "
                     f"residual {d.get('residual_chunks')} chunks, "
                     f"slack util {d.get('slack_utilization', 0):.2f}, "
                     f"feasible={d.get('feasible')}")

    for name, label in (("loss", "loss"), ("entropy", "entropy"),
                        ("ef_norm", "EF norm"), ("grad_norm", "grad norm")):
        pairs = _scalars(records, name)
        if pairs:
            lines.append(f"{label}: {_traj(pairs)}")

    ranks = _series(records, "dac_applied_ranks")
    if ranks:
        first, last = ranks[0], ranks[-1]
        lines.append(f"DAC ranks: step {first[0]} {first[1]} -> "
                     f"step {last[0]} {last[1]}")
    stage_ent = _series(records, "stage_entropy")
    if stage_ent:
        last = stage_ent[-1]
        lines.append("stage entropy (last): "
                     + " ".join(f"{v:.3f}" for v in last[1]))

    syn = _scalars(records, "bytes_synced")
    full = _scalars(records, "bytes_full")
    if syn and full:
        b_syn, b_full = syn[-1][1], full[-1][1]
        saved = b_full - b_syn
        ratio = b_full / b_syn if b_syn else float("inf")
        lines.append(f"wire bytes: {b_syn / 2**20:.1f} MiB compressed vs "
                     f"{b_full / 2**20:.1f} MiB raw "
                     f"({saved / 2**20:.1f} MiB saved, {ratio:.1f}x)")
    coded = _scalars(records, "wire_bytes_coded")
    raw = _scalars(records, "wire_bytes_raw")
    if coded and raw:
        b_c, b_r = coded[-1][1], raw[-1][1]
        bits = _scalars(records, "wire_bits")
        tag = (f", {int(bits[-1][1])}-bit last" if bits else "")
        lines.append(f"wire coding: {b_c / 2**20:.1f} MiB coded vs "
                     f"{b_r / 2**20:.1f} MiB uncoded payload "
                     f"({b_c / b_r:.2f}x raw{tag})" if b_r else
                     "wire coding: active (no payload bytes recorded)")
    swb = _series(records, "stage_wire_bytes")
    if swb:
        lines.append("per-stage wire bytes (last): "
                     + " ".join(str(int(v)) for v in swb[-1][1]))

    walls = _scalars(records, "wall_s")
    if len(walls) >= 2:
        dt = (walls[-1][1] - walls[0][1]) / max(1, walls[-1][0] - walls[0][0])
        lines.append(f"measured step time: {dt * 1e3:.1f} ms/step "
                     f"(over steps {walls[0][0]}..{walls[-1][0]})")

    timeline = [e for e in _events(records)
                if e.get("name") in ("fault_injected", "guard_skip",
                                     "ef_reset", "rollback", "recovered",
                                     "pod_drop", "pod_join",
                                     "telemetry_resume")]
    if timeline:
        lines.append("fault/recovery timeline:")
        for e in timeline:
            d = e.get("data", {})
            detail = " ".join(f"{k}={v}" for k, v in sorted(d.items()))
            lines.append(f"  step {e.get('step')}: {e.get('name')}"
                         + (f" ({detail})" if detail else ""))

    rounds = _events(records, "outer_round")
    if rounds:
        last = rounds[-1].get("data", {})
        lines.append(f"elastic: {len(rounds)} outer rounds, final "
                     f"n_pods={last.get('n_pods')} "
                     f"pod_losses={last.get('pod_losses')}")

    counters: dict[str, float] = {}
    for r in records:
        if r.get("kind") == "counter":
            counters[r["name"]] = counters.get(r["name"], 0) + r["value"]
    for name, total in sorted(counters.items()):
        lines.append(f"counter {name}: {total:g}")
    if not lines:
        lines.append("(no recognizable telemetry records)")
    return lines


def _emit_trace(records: list[dict], path: str) -> None:
    meta = next((e for e in _events(records, "run_meta")), None)
    if meta is None or not meta.get("data", {}).get("pipelined"):
        raise SystemExit("--trace needs a run_meta event from a pipelined run")
    d = meta["data"]
    S, M = int(d["num_stages"]), int(d["num_microbatches"])
    schedule = d.get("schedule", "1f1b")
    walls = _scalars(records, "wall_s")
    sim = simulate_schedule(schedule, S, M)
    if len(walls) >= 2:
        dt = (walls[-1][1] - walls[0][1]) / max(1, walls[-1][0] - walls[0][0])
        scale = dt / float(sim["makespan"])
    else:
        scale = 1e-3
    events = tick_trace_events(schedule, S, M, t_f=scale, t_b=scale,
                               time_unit_us=1e6)
    write_chrome_trace(path, events,
                       metadata={"source": "report", "schedule": schedule,
                                 "num_stages": S, "num_microbatches": M})
    stats = validate_trace({"traceEvents": events})
    print(f"trace: {path} ({stats['spans']} spans, "
          f"{stats['tracks']} tracks)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="summarize a telemetry JSONL run record")
    ap.add_argument("run", help="run directory (containing metrics.jsonl) "
                                "or a .jsonl path")
    ap.add_argument("--trace", default=None,
                    help="re-emit a Chrome trace JSON from the run's "
                         "schedule shape and measured step time")
    ap.add_argument("--csv", default=None,
                    help="export scalar/series/counter records as CSV")
    args = ap.parse_args(argv)

    path = _find_jsonl(args.run)
    records = read_jsonl(path)
    print(f"{path}: {len(records)} records")
    for line in build_report(records):
        print(line)
    if args.csv:
        write_csv(records, args.csv)
        print(f"csv: {args.csv}")
    if args.trace:
        _emit_trace(records, args.trace)


if __name__ == "__main__":
    main()
