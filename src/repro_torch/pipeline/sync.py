"""Per-stage DP-sync byte ledger (port of ``stage_wire_bytes`` in
``repro/pipeline/sync.py``; the per-stage sync executor is not ported yet).
"""
from __future__ import annotations

from repro_torch.core.compressor import CompressionPlan, LeafInfo, leaf_wire_bytes

__all__ = ["stage_wire_bytes"]


def stage_wire_bytes(leaves: list[LeafInfo], plan: CompressionPlan,
                     num_stages: int, bytes_per_elem: int = 2,
                     codec=None) -> list[tuple[int, int]]:
    """Per-stage (compressed, full) DP-sync bytes — Algorithm 2's ledger.

    Sums to ``plan_wire_bytes``; shared leaves are charged to the boundary
    stage ``_layer_stage`` pins them to. With a ``codec`` the compressed
    column is the coded payload and full stays the raw baseline.
    """
    out = [[0, 0] for _ in range(num_stages)]
    for info, (comp, full) in zip(leaves, leaf_wire_bytes(
            leaves, plan, bytes_per_elem, codec)):
        s = min(info.stage, num_stages - 1)
        out[s][0] += comp
        out[s][1] += full
    return [tuple(x) for x in out]
