"""Giving a traced window's device time to the program's spans.

The port records spans at the layer boundaries of its training step on the
host clock (``repro_torch.obs.trace.record_spans``: ``trainer.step``,
``trainer.batch``, ``step.forward``, ``step.backward``, ``step.sync``,
``step.entropy``, ``step.optimizer``, ``trainer.flush`` ...). A
``torch.profiler`` chrome trace gives ``ts`` in microseconds from its
``baseTimeNanoseconds``, so a span lands on the trace's clock at
``(t_ns - base_ns) / 1000``. Each kernel event carries ``args.correlation``,
which joins it to the runtime call that launched it; the kernel goes to the
innermost span open at that call, whichever thread made it (the backward's
launches come from autograd's engine thread while the main thread waits
inside ``step.backward``). Each idle gap of the window goes to the
innermost span open at its middle. All times are microseconds on the
trace's clock; the window and the busy time are ``bench.trace``'s.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import statistics

from bench import trace

OUTSIDE = "(outside every span)"
UNJOINED = "(no launch)"
#: the spans whose kernels the four phase numbers read
PHASES = ("step.forward", "step.backward", "step.sync", "step.optimizer")


@dataclasses.dataclass
class Placed:
    """A program span on the trace's clock."""

    name: str
    start: float
    end: float
    step: int | None


def _field(sp, key):
    return sp[key] if isinstance(sp, dict) else getattr(sp, key)


def place(spans, base_ns: int) -> list[Placed]:
    """The program's spans (``Span`` objects, or their fields as dicts) on
    the clock of a trace whose ``baseTimeNanoseconds`` is ``base_ns``."""
    return [Placed(_field(s, "name"), (_field(s, "start_ns") - base_ns) / 1e3,
                   (_field(s, "end_ns") - base_ns) / 1e3, _field(s, "step"))
            for s in spans]


class Innermost:
    """The innermost span open at a time: of the spans that contain it, the
    one that started last (spans of one thread nest)."""

    def __init__(self, placed: list[Placed]) -> None:
        self.spans = sorted(placed, key=lambda p: (p.start, -p.end))
        self.starts = [p.start for p in self.spans]

    def at(self, t: float) -> str:
        for j in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[j].end >= t:
                return self.spans[j].name
        return OUTSIDE


@dataclasses.dataclass
class Attribution:
    window: tuple[float, float]
    steps: int
    busy: dict[str, float]          # span name -> device busy us
    idle: dict[str, float]          # span name -> device idle us
    kernels: list[tuple[float, float, str, str]]   # (start, end, name, owner)
    gaps: list[tuple[float, float, str]]           # (start, end, owner)
    inner: Innermost

    @property
    def busy_us(self) -> float:
        return sum(self.busy.values())

    def by_span(self) -> list[list]:
        """[span name, device busy s, device idle s] for each span name
        seen in the window, by busy time."""
        names = sorted(set(self.busy) | set(self.idle),
                       key=lambda n: (-self.busy.get(n, 0.0), -self.idle.get(n, 0.0)))
        return [[n, self.busy.get(n, 0.0) / 1e6, self.idle.get(n, 0.0) / 1e6]
                for n in names]

    def phase_ms(self, name: str) -> float | None:
        """Device busy ms a step of the kernels launched inside ``name``."""
        us = self.busy.get(name, 0.0)
        return us / 1e3 / self.steps if us > 0 and self.steps else None

    def top_ops(self, n: int = 10) -> list[list]:
        """The device operations that took most time (``trace.top_ops``),
        each with its seconds split by the span that launched it:
        [name, seconds, {span: seconds}]."""
        by: dict[str, dict[str, float]] = {}
        for a, b, name, owner in self.kernels:
            d = by.setdefault(name, {})
            d[owner] = d.get(owner, 0.0) + (b - a)
        rows = sorted(by.items(), key=lambda kv: -sum(kv[1].values()))[:n]
        return [[name[:160], sum(d.values()) / 1e6,
                 {k: v / 1e6 for k, v in sorted(d.items(), key=lambda kv: -kv[1])}]
                for name, d in rows]

    def gaps_by_span(self) -> list[list]:
        """[span, idle gaps, their seconds, the longest gap's seconds] for
        each span that holds an idle gap, by seconds."""
        by: dict[str, list] = {}
        for a, b, owner in self.gaps:
            row = by.setdefault(owner, [owner, 0, 0.0, 0.0])
            row[1] += 1
            row[2] += (b - a) / 1e6
            row[3] = max(row[3], (b - a) / 1e6)
        return sorted(by.values(), key=lambda r: -r[2])

    def gaps_before(self, n: int = 5) -> list[list]:
        """Idle time summed by the kernel the device waited for (the first
        to start after each gap; ``trace.idle_gaps``'s ``host before``
        rows), split by span: [kernel, seconds, gaps, {span: seconds}]."""
        ks = sorted((a, name) for a, _, name, _ in self.kernels)
        starts = [a for a, _ in ks]
        by: dict[str, list] = {}
        for a, b, owner in self.gaps:
            i = bisect.bisect_left(starts, b)
            name = ks[i][1] if i < len(ks) else "(after the last kernel)"
            row = by.setdefault(name, [name[:160], 0.0, 0, {}])
            row[1] += (b - a) / 1e6
            row[2] += 1
            row[3][owner] = row[3].get(owner, 0.0) + (b - a) / 1e6
        return sorted(by.values(), key=lambda r: -r[1])[:n]

    def largest_gaps(self, n: int = 5) -> list[list]:
        """The longest idle gaps: [span, start us from the window's start,
        length s]."""
        rows = sorted(self.gaps, key=lambda g: -(g[1] - g[0]))[:n]
        return [[owner, a - self.window[0], (b - a) / 1e6] for a, b, owner in rows]


def _busy_owners(ks: list[tuple[float, float, str]]) -> dict[str, float]:
    """Each moment some kernel ran, given once: to the running kernel that
    started first, so the parts sum to the union of the intervals."""
    out: dict[str, float] = {}
    pts = sorted({x for a, b, _ in ks for x in (a, b)})
    order = sorted(range(len(ks)), key=lambda i: (ks[i][0], i))
    running: list[tuple[float, int]] = []       # a heap of (start, index)
    nxt = 0
    for x, y in zip(pts, pts[1:]):
        while nxt < len(order) and ks[order[nxt]][0] <= x:
            heapq.heappush(running, (ks[order[nxt]][0], order[nxt]))
            nxt += 1
        while running and ks[running[0][1]][1] <= x:
            heapq.heappop(running)
        if running:
            owner = ks[running[0][1]][2]
            out[owner] = out.get(owner, 0.0) + (y - x)
    return out


def attribute(events, spans, base_ns: int, steps: int = 0) -> Attribution:
    """Kernels, launches and idle gaps of the traced window of ``events``
    (a chrome trace's ``traceEvents``; the window as ``trace.from_events``
    bounds it) given to the program's ``spans``."""
    cap = trace.from_events(events, None, steps)
    lo, hi = cap.span
    inner = Innermost(place(spans, base_ns))
    launch_at: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch_at.setdefault(c, float(e["ts"]))
    kernels, owned = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        t = launch_at.get(e.get("args", {}).get("correlation"))
        owner = UNJOINED if t is None else inner.at(t)
        kernels.append((a, b, e.get("name", ""), owner))
        if b > lo and a < hi:
            owned.append((max(a, lo), min(b, hi), owner))
    busy = _busy_owners(owned)
    gaps, idle, t = [], {}, lo
    for a, b in trace.union([(a, b) for a, b, _ in owned]):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    named = []
    for a, b in gaps:
        owner = inner.at(0.5 * (a + b))
        idle[owner] = idle.get(owner, 0.0) + (b - a)
        named.append((a, b, owner))
    return Attribution((lo, hi), steps, busy, idle, kernels, named, inner)


def issue_ms(spans) -> float | None:
    """The median host duration of the ``trainer.step`` spans: how long
    the host takes to queue one step."""
    ms = [(_field(s, "end_ns") - _field(s, "start_ns")) / 1e6 for s in spans
          if _field(s, "name") == "trainer.step"]
    return statistics.median(ms) if ms else None


def summary(att: Attribution, spans) -> dict:
    """What a traced run with spans reads: ``by_span``, the four phase
    numbers and the host's time to queue a step, and the shares that say
    how much of the window the spans account for."""
    busy, idle = att.busy_us, sum(att.idle.values())
    free = att.busy.get(OUTSIDE, 0.0) + att.busy.get(UNJOINED, 0.0)
    covered = sum(att.busy.get(n, 0.0) for n in PHASES + ("step.entropy",))
    return {"by_span": att.by_span(),
            "step.forward_ms": att.phase_ms("step.forward"),
            "step.backward_ms": att.phase_ms("step.backward"),
            "step.optimizer_ms": att.phase_ms("step.optimizer"),
            "sync.device_ms": att.phase_ms("step.sync"),
            "host.issue_ms": issue_ms(spans),
            "busy_outside_share": free / busy if busy else None,
            "idle_outside_share": att.idle.get(OUTSIDE, 0.0) / idle if idle else None,
            "phases_busy_share": covered / busy if busy else None,
            "top_ops": att.top_ops(),
            "gaps_by_span": att.gaps_by_span(),
            "gaps_before": att.gaps_before(),
            "largest_gaps": att.largest_gaps()}
