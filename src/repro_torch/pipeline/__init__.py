"""Pipeline parallelism of the port (ROADMAP Queue 1 item 8).

- ``config``: :class:`PipelineConfig`, the pipeline-execution knobs.
- ``schedule``: the GPipe / 1F1B tick tables and their analytics.
- ``adapters`` / ``partition``: the family's stage adapter (dense).
- ``sync``: the per-stage DP sync and its compressor state, whole or by
  chunks (``stage_sync_chunks``).
- ``executor``: the pipelined train step and its transports
  (``LocalPipe``, ``DistPipe``); with ``overlap_sync`` each stage's sync
  chunks launch in the drain ticks.
"""
from .config import PIPELINE_FIELDS, PipelineConfig

__all__ = ["PipelineConfig", "PIPELINE_FIELDS"]
