"""PipelineConfig — the one home for pipeline-execution knobs.

Port of ``repro/pipeline/config.py``. A trainer given ``pipe=S`` runs
``num_stages`` = S stages; without it the stage count the DAC sees stays
virtual and execution runs one stage (the flat step).
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
