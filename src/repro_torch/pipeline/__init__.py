"""Pipeline surface of the port: the config and the per-stage byte ledger.

The pipelined executor itself is not ported yet (ROADMAP Queue 1 item 8).
"""
from .config import PIPELINE_FIELDS, PipelineConfig

__all__ = ["PipelineConfig", "PIPELINE_FIELDS"]
