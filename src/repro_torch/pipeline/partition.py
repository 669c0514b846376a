"""Stage partitioning: split a Model's params into S pipeline stages.

Port of ``repro/pipeline/partition.py``. Every family lays its
stage-assignable parameters under ``params['stages'][s]``, so partitioning
is a relayout:

  * **stage params**: the S per-stage stacks stacked into one tree whose
    leaves carry a leading stage dim ``(S, Lmax, ...)``, zero-padded where
    a stage owns fewer units than the widest stage (ragged plans);
  * **shared params**: everything else (embeddings, positional table,
    final norm, head). Each stage uses the pieces it owns, and their
    gradients are summed over the stages.

Which units land on which stage, what the boundary activation looks like
and how a stage computes are the family's
:class:`~repro_torch.pipeline.adapters.StageAdapter`'s: ``make_partition``
returns it (``remat`` False runs the stage's units without per-unit
recompute, which the stashed policies use).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.models.model import Model, ModelConfig
from repro_torch.pipeline.adapters import (
    StageAdapter,
    global_leaf_path,
    local_leaf_path,
    make_adapter,
    supported_reason,
)

__all__ = [
    "PipelinePartition",
    "make_partition",
    "merge_params",
    "partition_params",
    "pipeline_supported",
    "local_leaf_path",
    "global_leaf_path",
]

# The partition object IS the family's stage adapter.
PipelinePartition = StageAdapter


def pipeline_supported(cfg: ModelConfig, num_stages: int) -> str | None:
    """None if the config can run the pipeline executor, else the reason
    (from the family's own stage adapter, or naming the missing one)."""
    return supported_reason(cfg, num_stages)


def make_partition(model: Model, num_stages: int,
                   remat: bool | None = None) -> PipelinePartition:
    """Build the stage adapter for a model's family (see adapters.py)."""
    return make_adapter(model, num_stages, remat)


def partition_params(params: Any, num_stages: int) -> tuple[Any, Any]:
    """Uniform-layout split of ``params['stages']`` into (stacked, shared).

    For trees whose stages share one structure and equal stack sizes; the
    adapter's ``partition_params`` also handles ragged stages.
    """
    stages = params["stages"]
    if len(stages) != num_stages:
        raise ValueError(
            f"param layout has {len(stages)} stages, expected {num_stages}")
    stacked = tree.tree_map(lambda *xs: torch.stack(xs), *list(stages))
    shared = {k: v for k, v in params.items() if k != "stages"}
    return stacked, shared


def merge_params(stage_stacked: Any, shared: Any, num_stages: int) -> Any:
    """Inverse of :func:`partition_params`: back to the flat layout."""
    params = dict(shared)
    params["stages"] = [tree.tree_map(lambda a, s=s: a[s], stage_stacked)
                        for s in range(num_stages)]
    return params
