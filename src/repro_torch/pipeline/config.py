"""PipelineConfig — the one home for pipeline-execution knobs.

Port of ``repro/pipeline/config.py``. Only the flat path is ported so far,
so the trainer pins ``num_stages`` to 1 for execution; the DAC still sees
the model's virtual stage count through ``EDGCConfig.pipeline``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["PipelineConfig", "PIPELINE_FIELDS"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline-execution surface (hashable)."""

    num_stages: int = 1
    schedule: str = "1f1b"         # gpipe | 1f1b
    num_microbatches: int = 0      # 0 -> num_stages
    stash_policy: str = "replay"   # replay | full | every_k
    stash_every: int = 2
    overlap_sync: bool = False
    chunk_bytes: int = 0


PIPELINE_FIELDS = tuple(f.name for f in dataclasses.fields(PipelineConfig))
