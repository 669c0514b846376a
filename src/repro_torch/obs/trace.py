"""Pipeline tick tracer (tick tables -> Chrome trace-event JSON), the
program's spans, and the ``--profile`` hook.

Port of ``repro/obs/trace.py``. ``tick_trace_events`` renders the
dependency-timed schedule spans of ``pipeline.schedule.tick_spans`` as
Chrome trace-event ``X`` (complete) events: one track (tid) per pipeline
stage, one span per tick-table F/B entry, SYNC spans for an overlap plan's
in-loop chunk launches (``sync-residual`` for the post-loop spill), and
``bubble`` spans filling each stage's idle gaps. ``write_chrome_trace``'s
output loads in Perfetto / ``chrome://tracing``.

Time axis: ``tick_spans`` works in schedule seconds (units of
``t_f``/``t_b``); ``time_unit_us`` scales those to trace microseconds, so
a measured step time gives a trace whose makespan matches the real step
(``scale = measured_step_s / simulate_schedule(...)['makespan']``).

Program spans: ``span(name, **args)`` marks a layer of the training step
(``trainer.step``, ``step.forward``, ``step.sync`` ...) on the host clock
(``time.time_ns``), with the span that encloses it and the trainer's global
step. Nothing records outside a ``record_spans()`` block: there a span is
one check of a module-level flag, and it keeps, launches and synchronises
nothing. ``span_events`` places recorded spans on a ``torch.profiler``
trace's clock (``ts`` in microseconds from its ``baseTimeNanoseconds``), so
each kernel's launch can be given to the span that issued it.

``profiler_session`` wraps a run in a ``torch.profiler`` session and merges
the spans recorded in it into the trace it writes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any

from repro_torch.pipeline.schedule import (
    slot_table,
    stash_points,
    stash_segments,
    tick_spans,
)

__all__ = [
    "tick_trace_events",
    "write_chrome_trace",
    "load_trace",
    "validate_trace",
    "expected_span_count",
    "profiler_session",
    "Span",
    "span",
    "record_spans",
    "span_events",
]

# Span categories. The count oracle in tests matches cats in
# SCHEDULED_CATS one-to-one against slot_table entries; residual sync and
# bubble filler are annotations outside the tick table.
SCHEDULED_CATS = ("forward", "backward", "sync")
EXTRA_CATS = ("sync-residual", "bubble")


def _meta(pid: int, tid: int | None, name: str, label: str) -> dict:
    ev = {"ph": "M", "pid": pid, "name": name,
          "args": {"name": label}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def tick_trace_events(schedule: str, S: int, M: int, *,
                      t_f: float = 1.0, t_b: float = 1.0,
                      sync_plan: Any = None,
                      stash_policy: str = "replay", n_units: int = 0,
                      stash_every: int = 2,
                      time_unit_us: float = 1000.0,
                      pid: int = 0) -> list[dict]:
    """Chrome trace events for one pipelined step.

    Returns a flat event list: ``M`` metadata rows naming the process and
    one thread per stage, then ``X`` spans. F spans carry the tick,
    microbatch, and the stage's stash points; B spans carry the replayed
    stash segments; SYNC spans (when ``sync_plan`` is an ``OverlapPlan``)
    carry the chunk id and its planned launch tick. Exactly one
    forward/backward/sync span is emitted per ``slot_table`` entry.
    """
    spans = tick_spans(schedule, S, M, t_f, t_b)
    makespan = max(sp["end"] for sp in spans) if spans else 0.0
    us = float(time_unit_us)

    events: list[dict] = [_meta(pid, None, "process_name",
                                f"pipeline {schedule} S={S} M={M}")]
    for s in range(S):
        events.append(_meta(pid, s, "thread_name", f"stage {s}"))

    points = stash_points(stash_policy, n_units, stash_every) if n_units else ()
    segments = (stash_segments(stash_policy, n_units, stash_every)
                if n_units else ())

    busy: dict[int, list[tuple[float, float]]] = {s: [] for s in range(S)}
    for sp in spans:
        s = sp["stage"]
        fwd = sp["kind"] == "F"
        args = {"tick": sp["tick"], "microbatch": sp["mb"]}
        if fwd:
            args["stash_policy"] = stash_policy
            if points:
                args["stash_points"] = list(points)
        elif segments:
            args["replay_segments"] = [list(seg) for seg in segments]
        events.append({
            "ph": "X", "pid": pid, "tid": s,
            "name": f"{sp['kind']}{sp['mb']}",
            "cat": "forward" if fwd else "backward",
            "ts": sp["start"] * us, "dur": (sp["end"] - sp["start"]) * us,
            "args": args,
        })
        busy[s].append((sp["start"], sp["end"]))

    if sync_plan is not None:
        events.extend(_sync_events(sync_plan, spans, makespan, t_b, us,
                                   pid, busy))

    # Idle filler: per-stage gaps between scheduled work inside
    # [first_start, makespan]. Rendered as its own span so the bubble is
    # visible in Perfetto without mentally diffing tracks.
    for s in range(S):
        iv = sorted(busy[s])
        if not iv:
            continue
        cursor = iv[0][0]
        gaps = []
        for a, b in iv:
            if a > cursor + 1e-9:
                gaps.append((cursor, a))
            cursor = max(cursor, b)
        if makespan > cursor + 1e-9:
            gaps.append((cursor, makespan))
        for a, b in gaps:
            events.append({
                "ph": "X", "pid": pid, "tid": s, "name": "bubble",
                "cat": "bubble", "ts": a * us, "dur": (b - a) * us,
                "args": {},
            })
    return events


def _sync_events(plan: Any, spans: list[dict], makespan: float,
                 t_b: float, us: float, pid: int,
                 busy: dict[int, list[tuple[float, float]]]) -> list[dict]:
    """SYNC spans from an OverlapPlan.

    In-loop chunks chain sequentially from the stage's last backward end
    (that is when the overlapped executor launches them),
    each sized to its share of the launch tick's ``t_b`` budget; residual
    chunks chain after the makespan under cat ``sync-residual``.
    """
    events: list[dict] = []
    S = plan.num_stages
    for s in range(S):
        ends = [sp["end"] for sp in spans
                if sp["stage"] == s and sp["kind"] == "B"]
        cursor = max(ends) if ends else makespan
        for tick, chunk_ids in plan.launches[s]:
            dur = t_b / max(1, len(chunk_ids))
            for cid in chunk_ids:
                events.append({
                    "ph": "X", "pid": pid, "tid": s,
                    "name": f"SYNC c{cid}", "cat": "sync",
                    "ts": cursor * us, "dur": dur * us,
                    "args": {"chunk": int(cid), "planned_tick": int(tick),
                             "residual": False},
                })
                busy[s].append((cursor, cursor + dur))
                cursor += dur
        cursor = max(cursor, makespan)
        for cid in plan.residual[s]:
            events.append({
                "ph": "X", "pid": pid, "tid": s,
                "name": f"SYNC c{cid}", "cat": "sync-residual",
                "ts": cursor * us, "dur": t_b * us,
                "args": {"chunk": int(cid), "residual": True},
            })
            cursor += t_b
    return events


def write_chrome_trace(path: str, events: list[dict],
                       metadata: dict | None = None,
                       extra: dict | None = None) -> str:
    """Write a Chrome trace-event JSON object file (Perfetto-loadable);
    ``extra`` adds top-level keys (a profiler trace's
    ``baseTimeNanoseconds``, ``deviceProperties``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    obj = {**(extra or {}), "traceEvents": events, "displayTimeUnit": "ms",
           "otherData": metadata or {}}
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def validate_trace(obj: dict) -> dict:
    """Schema-check a trace object; raise ``ValueError`` on violations.

    Returns a summary (event counts per category, track count, makespan)
    that the CI smoke prints after validating.
    """
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be an object with a traceEvents list")
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    cats: dict[str, int] = {}
    tracks: set[tuple[int, int]] = set()
    end_us = 0.0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            raise ValueError(f"event {i}: missing ph/name")
        ph = ev["ph"]
        if ph == "M":
            continue
        if ph != "X":
            raise ValueError(f"event {i}: unexpected phase {ph!r}")
        for key in ("ts", "dur", "pid", "tid"):
            if not isinstance(ev.get(key), (int, float)):
                raise ValueError(f"event {i}: non-numeric {key}")
        if ev["dur"] < 0:
            raise ValueError(f"event {i}: negative dur")
        cat = ev.get("cat", "")
        cats[cat] = cats.get(cat, 0) + 1
        tracks.add((ev["pid"], ev["tid"]))
        end_us = max(end_us, ev["ts"] + ev["dur"])
    if not tracks:
        raise ValueError("trace has no X spans")
    return {"spans": sum(cats.values()), "by_cat": cats,
            "tracks": len(tracks), "end_us": end_us}


def expected_span_count(schedule: str, S: int, M: int,
                        sync_plan: Any = None) -> int:
    """Tick-table oracle: one scheduled span per slot_table entry."""
    table = slot_table(schedule, S, M, sync_plan)
    return sum(len(table[s][t]) for s in range(len(table))
               for t in range(len(table[s])))


# ------------------------------------------------------------ program spans
@dataclasses.dataclass
class Span:
    """One recorded span: its start and end on ``time.time_ns``, the index
    in the recorded list of the span that encloses it on the same thread
    (None at the top), the trainer's global step it belongs to (shared by
    every span of that step), and small host-side args (numbers,
    strings)."""

    name: str
    start_ns: int
    end_ns: int = 0
    parent: int | None = None
    step: int | None = None
    args: dict = dataclasses.field(default_factory=dict)


class _Recorder:
    def __init__(self) -> None:
        self.spans: list[Span] = []
        # thread ident -> the indices of its open spans, innermost last
        self.open: dict[int, list[int]] = {}


_ON = False                 # read by every span(); set by record_spans()
_REC: _Recorder | None = None
_OFF = contextlib.nullcontext()     # what span() returns while nothing records
_ARG_TYPES = (bool, int, float, str, type(None))


class _Open:
    __slots__ = ("rec", "name", "args", "sp", "stack")

    def __init__(self, rec: _Recorder, name: str, args: dict) -> None:
        self.rec, self.name, self.args = rec, name, args

    def __enter__(self) -> Span:
        rec, args = self.rec, self.args
        for k, v in args.items():
            if not isinstance(v, _ARG_TYPES):
                raise TypeError(f"span {self.name!r}: arg {k!r} is a "
                                f"{type(v).__name__}; a span keeps numbers "
                                "and strings only")
        self.stack = stack = rec.open.setdefault(threading.get_ident(), [])
        parent = stack[-1] if stack else None
        step = args.pop("step", None)
        if step is None and parent is not None:
            step = rec.spans[parent].step
        sp = Span(self.name, 0, parent=parent, step=step, args=args)
        stack.append(len(rec.spans))
        rec.spans.append(sp)
        self.sp = sp
        sp.start_ns = time.time_ns()
        return sp

    def __exit__(self, *exc) -> bool:
        self.sp.end_ns = time.time_ns()
        self.stack.pop()
        return False


def span(name: str, **args):
    """A context manager that records ``name`` from its entry to its exit
    while a ``record_spans()`` block is open, and does nothing otherwise.
    ``step=`` sets the global step (the enclosing span's by default); other
    args must be numbers or strings."""
    if not _ON:
        return _OFF
    return _Open(_REC, name, args)


@contextlib.contextmanager
def record_spans():
    """Record the spans opened inside the block; yields the list they are
    appended to (in order of entry). Only the caller writes them out."""
    global _ON, _REC
    if _ON:
        raise RuntimeError("record_spans() is already recording")
    _REC, _ON = _Recorder(), True
    try:
        yield _REC.spans
    finally:
        _ON, _REC = False, None


def span_events(spans: list[Span], base_ns: int = 0, pid: int | None = None,
                tid: int = 0) -> list[dict]:
    """Chrome ``X`` events of ``spans`` on a trace's clock: ``ts`` in
    microseconds from ``base_ns`` (a ``torch.profiler`` trace's
    ``baseTimeNanoseconds``), on one track of their own (``pid``, default
    this process, and ``tid``), named by an ``M`` event."""
    pid = os.getpid() if pid is None else pid
    events = [_meta(pid, tid, "thread_name", "program spans")]
    for sp in spans:
        args = {"step": sp.step, **sp.args}
        if sp.parent is not None:
            args["parent"] = spans[sp.parent].name
        events.append({"ph": "X", "pid": pid, "tid": tid, "name": sp.name,
                       "cat": "program", "ts": (sp.start_ns - base_ns) / 1e3,
                       "dur": (sp.end_ns - sp.start_ns) / 1e3, "args": args})
    return events


def _merge_spans(path: str, spans: list[Span]) -> None:
    """Add ``spans`` to the ``torch.profiler`` trace at ``path`` on its
    clock."""
    obj = load_trace(path)
    events = span_events(spans, int(obj.get("baseTimeNanoseconds", 0)))
    validate_trace({"traceEvents": events})
    extra = {k: v for k, v in obj.items()
             if k not in ("traceEvents", "displayTimeUnit", "otherData")}
    write_chrome_trace(path, obj["traceEvents"] + events,
                       obj.get("otherData"), extra=extra)


@contextlib.contextmanager
def profiler_session(enabled: bool, logdir: str):
    """Profile the enclosed run when ``enabled`` (a no-op otherwise).

    Records every activity this build of torch supports (the CPU, and
    CUDA where present) and the program's spans, and writes a Chrome trace
    (Perfetto-loadable) to ``<logdir>/trace.json`` when the block ends,
    the spans on a track of their own on the trace's clock.
    """
    if not enabled:
        yield None
        return
    from torch.profiler import profile, supported_activities
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=list(supported_activities())) as prof:
        with record_spans() as spans:
            yield logdir
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    if spans:
        _merge_spans(path, spans)
