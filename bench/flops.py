"""The benchmark's counts of work, from the configuration's shapes alone.

``model_flops_per_token``: the model FLOPs of one training token as the
PaLM paper's appendix B counts them (Chowdhery et al., 2022): 6 N for the
weights that take part in a matrix product for each token (every layer's
projections and the output head once; the lookup, norms and biases left
out), plus 12 L d T for attention's two products over T positions, with
no recomputation counted.

``shape_groups`` and ``powersgd_work``: the compression work of one step,
the same whatever kernels run it. Per (m, n) matrix at rank r: the EF add
M = G + E, P = M Q, the orthonormalisation of P, Q' = M^T P, g^ = P Q'^T
and E' = M - g^. G is read and g^ written once in the parameters' dtype,
E read and E' written once in fp32 (the residual's type); the factors P
and Q' count only where they must leave the chip (DP over several cards).

Peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity): 989 TFLOP/s in
bf16, 67 TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s of HBM.
"""
from __future__ import annotations

import dataclasses
import math
import re

from bench import weights

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

#: what the port's plan leaves uncompressed, by path (its ``DEFAULT_EXCLUDE``)
EXCLUDE = re.compile(r"(embed|lm_head|norm|bias|scale|router|conv|a_log|dt|state"
                     r"|shared|dec_pos|projector)", re.IGNORECASE)
MIN_COMPRESS_DIM = 64


def matmul_params(m: dict) -> int:
    """N: the weights in a matrix product for each token."""
    d, ff = m["d_model"], m["d_ff"]
    hq = m["num_heads"] * weights.head_dim(m)
    hkv = m["num_kv_heads"] * weights.head_dim(m)
    per_layer = d * hq + 2 * d * hkv + hq * d + (3 if weights.gated(m) else 2) * d * ff
    return m["num_layers"] * per_layer + d * m["vocab_size"]


def model_flops_per_token(m: dict, seq: int) -> float:
    attn = 12 * m["num_layers"] * m["num_heads"] * weights.head_dim(m) * seq
    return 6.0 * matmul_params(m) + attn


@dataclasses.dataclass(frozen=True)
class Group:
    """E matrices of (m, n) compressed at rank r."""

    stack: int
    m: int
    n: int
    rank: int


def compressed(leaf: weights.Leaf) -> bool:
    """Whether the plan compresses a leaf: matrices (>= 2-D) whose two
    trailing dims are both at least 64, outside the excluded names."""
    return (len(leaf.shape) >= 2 and min(leaf.shape[-2:]) >= MIN_COMPRESS_DIM
            and EXCLUDE.search(leaf.keystr) is None)


def leaf_rank(leaf: weights.Leaf, rank: int) -> int:
    return max(1, min(rank, min(leaf.shape[-2:]) // 2))


def shape_groups(m: dict, rank: int) -> list[Group]:
    """Every compressed matrix of the model grouped by (m, n, rank)."""
    count: dict[tuple, int] = {}
    for leaf in weights.leaves(m):
        if compressed(leaf):
            key = (leaf.shape[-2], leaf.shape[-1], leaf_rank(leaf, rank))
            count[key] = count.get(key, 0) + math.prod(leaf.shape[:-2])
    return [Group(e, a, b, r) for (a, b, r), e in count.items()]


def powersgd_work(groups, param_bytes: int, world: int = 1) -> tuple[float, float]:
    """(FLOPs, bytes) of one step's compression over ``groups``."""
    flops = nbytes = 0.0
    for g in groups:
        mn = g.stack * g.m * g.n
        flops += 3 * 2 * mn * g.rank + 2 * mn          # three products, EF add, residual
        flops += g.stack * 2 * g.m * g.rank * g.rank    # orthonormalising P (m x r)
        nbytes += mn * (2 * param_bytes + 2 * 4)        # G, g^ ; E, E'
        if world > 1:
            nbytes += g.stack * (g.m + g.n) * g.rank * 4 * 2   # P, Q' out and back
    return flops, nbytes


def least_seconds(flops: float, nbytes: float,
                  peak_flops: float = PEAK_FP32_FLOPS) -> float:
    """The roofline: the larger of the operations over the peak and the
    bytes over the memory's bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
