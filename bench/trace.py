"""Reading a ``torch.profiler`` trace: kernels, launches, host ops, idle gaps.

All times are microseconds on the trace's clock. ``Captured`` holds what a
traced window recorded; the per-layer metric readers in ``metrics/`` and
the result's ``breakdown`` are computed from it with the interval
arithmetic below (the union of kernel intervals over all streams, the
overlap of one stream with another, percentiles).
"""
from __future__ import annotations

import bisect
import dataclasses
import math

#: CUDA runtime and driver calls that launch device work
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch")


@dataclasses.dataclass
class Kernel:
    start: float
    end: float
    name: str
    stream: str


@dataclasses.dataclass
class Captured:
    kernels: list[Kernel]
    launches: int                       # runtime launch calls
    host_ops: list[tuple[float, float, str]]   # the launching thread's ops
    span: tuple[float, float]           # the traced window on the trace's clock
    steps: int                          # training steps inside it

    @property
    def window_us(self) -> float:
        return self.span[1] - self.span[0]


def union(spans) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(spans) -> float:
    return sum(b - a for a, b in union(spans))


def clip(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def busy_us(cap: Captured) -> float:
    """Time in which some kernel ran on the device, on any stream."""
    return covered(clip([(k.start, k.end) for k in cap.kernels], *cap.span))


def stream_time(kernels) -> dict[str, float]:
    out: dict[str, float] = {}
    for k in kernels:
        out[k.stream] = out.get(k.stream, 0.0) + (k.end - k.start)
    return out


def side_overlap(kernels) -> tuple[float, float] | None:
    """(kernel time off the compute stream, the part of it that ran while a
    compute-stream kernel ran); the compute stream is the one with the most
    kernel time. None with one stream."""
    by = stream_time(kernels)
    if len(by) < 2:
        return None
    main = max(by, key=by.get)
    busy = union([(k.start, k.end) for k in kernels if k.stream == main])
    side = [(k.start, k.end) for k in kernels if k.stream != main]
    total = sum(b - a for a, b in side)
    over = 0.0
    starts = [a for a, _ in busy]
    for a, b in side:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(busy) and busy[i][0] < b:
            over += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
    return total, over


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def top_ops(cap: Captured, n: int = 10) -> list[list]:
    """The device operations that took most time: [name, seconds]."""
    by: dict[str, float] = {}
    for k in cap.kernels:
        by[k.name] = by.get(k.name, 0.0) + (k.end - k.start)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in rows]


def idle_gaps(cap: Captured, n: int = 10) -> list[list]:
    """The device's idle time inside the window, summed by what the host
    was doing at each gap's middle: the innermost host call of the
    launching thread there (``host in <call>``), or, where none ran, the
    kernel the device waited for (``host before <kernel>``):
    [name, seconds]."""
    ks = sorted(clip([(k.start, k.end) for k in cap.kernels], *cap.span))
    names = {(k.start, k.end): k.name for k in cap.kernels}
    busy = union(ks)
    gaps, t = [], cap.span[0]
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if cap.span[1] > t:
        gaps.append((t, cap.span[1]))
    ops = sorted(op for op in cap.host_ops if op[2] not in LAUNCH_CALLS)
    starts = [a for a, _, _ in ops]
    kstarts = [a for a, _ in ks]
    by: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = None
        # the innermost op covering ``mid``: the latest-starting one that
        # has not ended by then
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if ops[j][1] >= mid:
                name = "host in " + ops[j][2]
                break
            if mid - ops[j][0] > 1e6:
                break
        if name is None:
            i = bisect.bisect_left(kstarts, b)
            name = ("host before " + names.get(ks[i], "?")) if i < len(ks) else "host after the last kernel"
        by[name] = by.get(name, 0.0) + (b - a)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in rows]


def from_events(events, span=None, steps: int = 0) -> Captured:
    """What a ``torch.profiler`` chrome trace's events recorded. ``span``
    bounds the window on the trace's clock; by default it runs from the
    first launch to the last kernel's end."""
    kernels, runtime, cpu = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "kernel":
            stream = e.get("args", {}).get("stream", e.get("tid"))
            kernels.append(Kernel(ts, ts + dur, e.get("name", ""), str(stream)))
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime.append((ts, ts + dur, e.get("name", ""), e.get("tid")))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            cpu.append((ts, ts + dur, e.get("name", ""), e.get("tid")))
    launches = [r for r in runtime if r[2] in LAUNCH_CALLS]
    # the launching thread: the one that issued the most launches
    tids: dict = {}
    for r in launches:
        tids[r[3]] = tids.get(r[3], 0) + 1
    main = max(tids, key=tids.get) if tids else None
    host = [(a, b, n) for a, b, n, t in cpu + runtime if t == main]
    if span is None:
        # from the first launch to the last kernel's end; without kernels,
        # the host's first and last call
        if kernels and launches:
            span = (min(r[0] for r in launches), max(k.end for k in kernels))
        else:
            pts = [a for a, _, _ in host] + [b for _, b, _ in host]
            span = (min(pts), max(pts)) if pts else (0.0, 0.0)
    n_launch = sum(1 for r in launches if span[0] <= r[0] <= span[1])
    return Captured(kernels, n_launch, host, span, steps)
