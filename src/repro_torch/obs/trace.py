"""The ``--profile`` hook: a ``torch.profiler`` session around a run.

Port of ``profiler_session`` from ``repro/obs/trace.py``. The tick tracer
of that module (tick tables -> Chrome trace-event JSON) renders the
pipeline schedule and comes with the pipeline's port (ROADMAP Queue 1
item 8).
"""
from __future__ import annotations

import contextlib
import os

__all__ = ["profiler_session"]


@contextlib.contextmanager
def profiler_session(enabled: bool, logdir: str):
    """Profile the enclosed run when ``enabled`` (a no-op otherwise).

    Records every activity this build of torch supports (the CPU, and
    CUDA where present) and writes a Chrome trace (Perfetto-loadable) to
    ``<logdir>/trace.json`` when the block ends.
    """
    if not enabled:
        yield None
        return
    from torch.profiler import profile, supported_activities
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=list(supported_activities())) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
