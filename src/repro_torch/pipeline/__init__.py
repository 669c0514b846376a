"""Pipeline parallelism of the port (ROADMAP Queue 1 item 8a).

- ``config``: :class:`PipelineConfig`, the pipeline-execution knobs.
- ``schedule``: the GPipe / 1F1B tick tables and their analytics.
- ``adapters`` / ``partition``: the family's stage adapter (dense).
- ``sync``: the per-stage DP sync and its compressor state.
- ``executor``: the pipelined train step and its transports
  (``LocalPipe``, ``DistPipe``).

The sync overlapped with the drain ticks is item 8b.
"""
from .config import PIPELINE_FIELDS, PipelineConfig

__all__ = ["PipelineConfig", "PIPELINE_FIELDS"]
