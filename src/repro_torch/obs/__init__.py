"""Telemetry of the port: structured metrics and the profiler hook.

- ``repro_torch.obs.metrics`` — :class:`MetricsRegistry` with typed
  scalar/series/counter/event emitters and pluggable sinks (JSONL file,
  in-memory for tests, CSV export). Device values reach the host in one
  batched copy at flush boundaries only.
- ``repro_torch.obs.trace`` — the pipeline tick tracer (tick tables ->
  Chrome trace-event JSON), the program's spans (``span``, recorded only
  inside ``record_spans()``, placed on a profiler trace's clock by
  ``span_events``) and the ``--profile`` ``torch.profiler`` hook.
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
from repro_torch.obs.trace import (  # noqa: F401
    Span,
    expected_span_count,
    load_trace,
    profiler_session,
    record_spans,
    span,
    span_events,
    tick_trace_events,
    validate_trace,
    write_chrome_trace,
)

__all__ = [
    "JsonlSink",
    "MemorySink",
    "MetricsRegistry",
    "fetch",
    "read_jsonl",
    "write_csv",
    "profiler_session",
    "tick_trace_events",
    "write_chrome_trace",
    "load_trace",
    "validate_trace",
    "expected_span_count",
    "Span",
    "span",
    "record_spans",
    "span_events",
]
