"""Structured telemetry: a typed metrics registry with pluggable sinks.

Port of ``repro/obs/metrics.py``. The :class:`MetricsRegistry` makes the
control plane's per-step signals first-class records:

  scalar   one float per step           (loss, pooled entropy, lr, coded
                                         vs raw wire-format bytes, ...)
  series   one list per step            (per-stage ranks, wire bytes, ...)
  counter  monotone cumulative count    (ef_resets, rollbacks, ...)
  event    structured occurrence        (fault_injected, plan_change, ...)

Every record is one JSON-able dict ``{"kind", "name", "step", "wall",
...payload}`` delivered to every attached sink. :class:`JsonlSink`
appends one JSON line per record (the run's on-disk telemetry, read by
``repro_torch.launch.report``), :class:`MemorySink` collects them for
tests, and :func:`write_csv` exports any record list as CSV.

Device-sync discipline: ``scalar``/``series`` values may be live
``torch.Tensor``\\ s, on any device. The registry buffers records without
converting them; ``flush()`` brings every pending tensor to the host in
one batched copy (:func:`fetch`), so a training loop can emit every step
and still only wait for the device at its flush boundaries.

The registry's cursor (last step, counters, emitted-record count) is a
``state_dict()`` the trainer serializes through checkpoint ``extra``: a
resumed run appends to its telemetry instead of restarting at step 0.
"""
from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Iterable

import numpy as np
import torch

__all__ = [
    "JsonlSink",
    "MemorySink",
    "MetricsRegistry",
    "fetch",
    "write_csv",
    "read_jsonl",
]

def fetch(tensors: list[torch.Tensor]) -> list[Any]:
    """Host values of ``tensors`` in ONE device-to-host copy.

    Every tensor is flattened and widened to float64 (exact for the fp32,
    bf16 and int32 values that telemetry carries) on the first tensor's
    device, concatenated, and copied once; each comes back as a Python
    number (0-d) or a nested list, int or bool where its dtype was.
    """
    if not tensors:
        return []
    dev = tensors[0].device
    flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float64)
                      for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        a = flat[off:off + n].reshape(tuple(t.shape))
        off += n
        if t.dtype == torch.bool:
            a = a.astype(bool)
        elif not t.is_floating_point():
            a = a.astype(np.int64)
        out.append(a.item() if a.ndim == 0 else a.tolist())
    return out


def _to_host(x: Any) -> Any:
    if isinstance(x, (list, tuple)):
        return [_to_host(v) for v in x]
    if isinstance(x, (str, bool, int)) or x is None:
        return x
    try:
        a = np.asarray(x)
        if a.ndim == 0:
            v = a.item()
            return float(v) if isinstance(v, float) else v
        return a.tolist()
    except Exception:
        return x


class JsonlSink:
    """Append-mode JSONL file sink: one record per line.

    Append (not truncate) so a resumed run continues the same file — the
    registry's ``telemetry_resume`` event marks the boundary.
    """

    def __init__(self, path: str, mode: str = "a") -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, mode)

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class MemorySink:
    """In-memory sink for tests and benchmark harnesses."""

    def __init__(self) -> None:
        self.records: list[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    # ---- query helpers (assertion-friendly views) -----------------------
    def of_kind(self, kind: str) -> list[dict]:
        return [r for r in self.records if r["kind"] == kind]

    def scalars(self, name: str) -> list[tuple[int, float]]:
        return [(r["step"], r["value"]) for r in self.of_kind("scalar")
                if r["name"] == name]

    def series(self, name: str) -> list[tuple[int, list]]:
        return [(r["step"], r["values"]) for r in self.of_kind("series")
                if r["name"] == name]

    def counters(self, name: str) -> list[tuple[int, int]]:
        return [(r["step"], r["value"]) for r in self.of_kind("counter")
                if r["name"] == name]

    def events(self, name: str | None = None) -> list[dict]:
        evs = self.of_kind("event")
        return evs if name is None else [r for r in evs if r["name"] == name]


def read_jsonl(path: str) -> list[dict]:
    """Load a JSONL telemetry file back into a record list."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def write_csv(records: Iterable[dict], path: str) -> str:
    """Export scalar/series/counter records as CSV (step,name,kind,value).

    Series values join with ';' so per-stage trajectories stay one row per
    step; event records are skipped (they are not tabular).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step", "name", "kind", "value"])
        for r in records:
            if r["kind"] == "event":
                continue
            val = (";".join(str(v) for v in r["values"])
                   if r["kind"] == "series" else r["value"])
            w.writerow([r["step"], r["name"], r["kind"], val])
    return path


class MetricsRegistry:
    """Typed emitters + deferred host conversion + cursor state.

    ``sinks`` may be empty: emitting stays cheap (dict construction only)
    and the cursor/counters still advance, so callers never need a null
    check. ``tags`` ride on every record (``with_tags`` derives a view
    that adds more).
    """

    def __init__(self, sinks: Iterable[Any] = (), *,
                 tags: dict | None = None, step: int = 0) -> None:
        self.sinks = list(sinks)
        self._tags = dict(tags or {})
        self._pending: list[dict] = []
        self._counters: dict[str, int] = {}
        self.last_step = step
        self.n_emitted = 0
        self._t0 = time.time()

    # ---------------------------------------------------------- emitters
    def _rec(self, kind: str, name: str, step: int | None,
             **payload: Any) -> None:
        if step is None:
            step = self.last_step
        self.last_step = max(self.last_step, int(step))
        rec = {"kind": kind, "name": name, "step": int(step),
               "wall": round(time.time() - self._t0, 6), **payload}
        if self._tags:
            rec.update(self._tags)
        self._pending.append(rec)

    def scalar(self, name: str, value: Any, step: int | None = None) -> None:
        self._rec("scalar", name, step, value=value)

    def series(self, name: str, values: Any, step: int | None = None) -> None:
        self._rec("series", name, step, values=values)

    def counter(self, name: str, inc: int = 1,
                step: int | None = None) -> int:
        total = self._counters.get(name, 0) + int(inc)
        self._counters[name] = total
        self._rec("counter", name, step, value=total, inc=int(inc))
        return total

    def event(self, name: str, step: int | None = None,
              **data: Any) -> None:
        self._rec("event", name, step, data=data)

    def with_tags(self, **tags: Any) -> "_TaggedView":
        """A write-through view adding ``tags`` to every record.

        The view shares this registry's sinks, counters, cursor, and
        pending buffer — ``state_dict``/``flush`` on either see the same
        state.
        """
        return _TaggedView(self, {**self._tags, **tags})

    # ------------------------------------------------------------- flush
    def flush(self) -> None:
        """Convert pending values to host (ONE batched device copy) and
        deliver them to every sink."""
        if not self._pending:
            for s in self.sinks:
                s.flush()
            return
        tensors = []
        for rec in self._pending:
            for key in ("value", "values"):
                v = rec.get(key)
                if isinstance(v, torch.Tensor):
                    tensors.append(v)
                elif isinstance(v, (list, tuple)):
                    tensors.extend(x for x in v if isinstance(x, torch.Tensor))
        host = iter(fetch(tensors))
        swap = lambda x: next(host) if isinstance(x, torch.Tensor) else x
        for rec in self._pending:
            for key in ("value", "values"):
                if key in rec:
                    v = rec[key]
                    v = ([swap(x) for x in v] if isinstance(v, (list, tuple))
                         else swap(v))
                    rec[key] = _to_host(v)
            if "data" in rec:
                rec["data"] = _to_host(rec["data"])
            for s in self.sinks:
                s.emit(rec)
        self.n_emitted += len(self._pending)
        self._pending.clear()
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        self.flush()
        for s in self.sinks:
            s.close()

    # ------------------------------------------------------ cursor state
    def state_dict(self) -> dict:
        """Checkpoint-able cursor: serialized through the trainer's
        checkpoint ``extra`` so a resumed run appends instead of
        restarting its series at step 0."""
        return {"step": int(self.last_step),
                "emitted": int(self.n_emitted),
                "counters": dict(self._counters)}

    def load_state_dict(self, sd: dict) -> None:
        self.last_step = int(sd.get("step", 0))
        self.n_emitted = int(sd.get("emitted", 0))
        self._counters = {k: int(v)
                          for k, v in sd.get("counters", {}).items()}
        self.event("telemetry_resume", step=self.last_step,
                   emitted=self.n_emitted)


class _TaggedView:
    """Write-through registry view adding fixed tags to each record."""

    def __init__(self, base: MetricsRegistry, tags: dict) -> None:
        self._base = base
        self._tags = tags

    def _rec(self, kind, name, step, **payload):
        saved = self._base._tags
        self._base._tags = self._tags
        try:
            self._base._rec(kind, name, step, **payload)
        finally:
            self._base._tags = saved

    def scalar(self, name, value, step=None):
        self._rec("scalar", name, step, value=value)

    def series(self, name, values, step=None):
        self._rec("series", name, step, values=values)

    def counter(self, name, inc=1, step=None):
        total = self._base._counters.get(name, 0) + int(inc)
        self._base._counters[name] = total
        self._rec("counter", name, step, value=total, inc=int(inc))
        return total

    def event(self, name, step=None, **data):
        self._rec("event", name, step, data=data)

    def with_tags(self, **tags):
        return _TaggedView(self._base, {**self._tags, **tags})

    def flush(self):
        self._base.flush()

    def close(self):
        self._base.close()

    def state_dict(self):
        return self._base.state_dict()

    def load_state_dict(self, sd):
        self._base.load_state_dict(sd)

    @property
    def last_step(self):
        return self._base.last_step

    @property
    def n_emitted(self):
        return self._base.n_emitted

    @property
    def sinks(self):
        return self._base.sinks
