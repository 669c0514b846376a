"""Telemetry of the port: structured metrics and the profiler hook.

- ``repro_torch.obs.metrics`` — :class:`MetricsRegistry` with typed
  scalar/series/counter/event emitters and pluggable sinks (JSONL file,
  in-memory for tests, CSV export). Device values reach the host in one
  batched copy at flush boundaries only.
- ``repro_torch.obs.trace`` — the ``--profile`` ``torch.profiler`` hook.
  The pipeline tick tracer comes with the pipeline (ROADMAP item 8).
- ``repro_torch.launch.report`` — CLI rendering a run's JSONL telemetry as
  a text summary.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    JsonlSink,
    MemorySink,
    MetricsRegistry,
    fetch,
    read_jsonl,
    write_csv,
)
from repro_torch.obs.trace import profiler_session  # noqa: F401

__all__ = [
    "JsonlSink",
    "MemorySink",
    "MetricsRegistry",
    "fetch",
    "read_jsonl",
    "write_csv",
    "profiler_session",
]
