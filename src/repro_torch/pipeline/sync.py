"""Per-stage DP-sync byte ledger (port of ``stage_wire_bytes`` in
``repro/pipeline/sync.py``; the per-stage sync executor is not ported yet).
"""
from __future__ import annotations

from repro_torch.core.compressor import CompressionPlan, LeafInfo
from repro_torch.core.powersgd import compressed_bytes

__all__ = ["stage_wire_bytes"]


def stage_wire_bytes(leaves: list[LeafInfo], plan: CompressionPlan,
                     num_stages: int,
                     bytes_per_elem: int = 2) -> list[tuple[int, int]]:
    """Per-stage (compressed, full) DP-sync bytes — Algorithm 2's ledger.

    Sums to ``plan_wire_bytes``; shared leaves are charged to the boundary
    stage ``_layer_stage`` pins them to.
    """
    rank_by_path = plan.as_dict()
    out = [[0, 0] for _ in range(num_stages)]
    for info in leaves:
        s = min(info.stage, num_stages - 1)
        nelem = 1
        for d in info.shape:
            nelem *= d
        out[s][1] += nelem * bytes_per_elem
        if info.path in rank_by_path:
            out[s][0] += compressed_bytes(info.shape, rank_by_path[info.path],
                                          bytes_per_elem)
        else:
            out[s][0] += nelem * bytes_per_elem
    return [tuple(x) for x in out]
