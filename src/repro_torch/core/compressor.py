"""Gradient-sync compressor: policies, leaf classification, plans, state.

Port of ``repro/core/compressor.py``. It decides which gradient leaves are
low-rank compressed and at what rank, then runs compress -> (injected
psum) -> decompress with error feedback for those leaves and a plain psum
for the rest.

Policies (one code path; they differ only in plan-making):

  * ``none``    — full-gradient all-reduce.
  * ``fixed``   — PowerSGD baseline: one static rank everywhere.
  * ``optimus`` — static rank, first/last stage relaxed.
  * ``edgc``    — per-stage dynamic ranks from the DAC controller.

Leaf paths are ``keystr`` strings from :mod:`repro_torch.tree`, identical
to the reference's, so the regexes below classify the same leaves.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.dist import tp
from repro_torch.dist.collectives import make_model_psum, model_all_gather
from . import bucketing
from . import wire as _wire
from .bucketing import BucketLayout
from .config import DEFAULT_BUCKET_BYTES
from .powersgd import (LowRankState, compress_leaf, compress_leaf_tp,
                       compressed_bytes, fold_in, init_leaf_state, resize_rank)

__all__ = ["LeafInfo", "CompressionPlan", "NO_COMPRESSION", "classify_leaves",
           "make_plan", "init_compressor_state", "sync_grads",
           "plan_wire_bytes", "leaf_wire_bytes", "resize_compressor_state"]

PsumFn = Callable[[torch.Tensor], torch.Tensor]

DEFAULT_EXCLUDE = (
    r"(embed|lm_head|norm|bias|scale|router|conv|a_log|dt|state"
    r"|shared|dec_pos|projector)"
)

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64"}


@dataclasses.dataclass(frozen=True)
class LeafInfo:
    path: str
    shape: tuple[int, ...]
    stage: int          # pipeline stage (0-based) this leaf belongs to
    eligible: bool      # structurally compressible (>=2-D, big enough)
    dtype: str | None = None   # param dtype name (None: unknown, assume fp32)

    @property
    def itemsize(self) -> int:
        """Bytes per element on the raw wire (4 when dtype is unknown)."""
        if not self.dtype:
            return 4
        if self.dtype == "bfloat16":
            return 2
        return int(np.dtype(self.dtype).itemsize)


_STAGE0_PAT = re.compile(r"embed|wte|wpe|patch_proj|pos|projector|shared",
                         re.IGNORECASE)
_STAGE_LAST_PAT = re.compile(r"lm_head|final_norm|head\b", re.IGNORECASE)
_STAGE_IDX_PAT = re.compile(r"stages?\W{0,3}(\d+)")
_LAYER_IDX_PAT = re.compile(r"layers?[/\[.](\d+)")


def _layer_stage(path: str, num_layers: int, num_stages: int,
                 param_stages: int | None = None) -> int:
    """Map a param path to its pipeline stage (see the reference)."""
    if num_stages <= 1:
        return 0
    m = _STAGE_IDX_PAT.search(path)
    if m is not None:
        i = int(m.group(1))
        groups = max(param_stages or num_stages, i + 1)
        return min(num_stages - 1, i * num_stages // groups)
    if _STAGE0_PAT.search(path):
        return 0
    if _STAGE_LAST_PAT.search(path):
        return num_stages - 1
    m = _LAYER_IDX_PAT.search(path)
    if m is None:
        m = re.search(r"\b(\d+)\b", path) if "layer" in path else None
    if m is None or num_layers <= 0:
        return 0
    layer = int(m.group(1))
    return min(num_stages - 1, layer * num_stages // max(1, num_layers))


def classify_leaves(params: Any, num_layers: int, num_stages: int = 1,
                    min_dim: int = 64,
                    exclude: str = DEFAULT_EXCLUDE) -> list[LeafInfo]:
    """Walk the param tree and classify every leaf.

    Eligibility: >=2-D, both matricized dims >= min_dim, path not excluded.
    """
    flat = tree.flatten_with_path(params)
    pat = re.compile(exclude, re.IGNORECASE)
    idxs = [int(m.group(1)) for p, _ in flat
            for m in [_STAGE_IDX_PAT.search(p)] if m is not None]
    param_stages = (max(idxs) + 1) if idxs else None
    infos = []
    for path, leaf in flat:
        shape = tuple(leaf.shape)
        mat_dims = shape[-2:] if len(shape) >= 2 else shape
        eligible = (len(shape) >= 2 and len(mat_dims) == 2
                    and min(mat_dims) >= min_dim and pat.search(path) is None)
        dtype = getattr(leaf, "dtype", None)
        infos.append(LeafInfo(
            path=path, shape=shape,
            stage=_layer_stage(path, num_layers, num_stages, param_stages),
            eligible=eligible,
            dtype=_DTYPE_NAMES.get(dtype, str(dtype)) if dtype is not None else None,
        ))
    return infos


@dataclasses.dataclass(frozen=True)
class CompressionPlan:
    """Static (hashable) map path -> rank for compressed leaves."""

    ranks: tuple[tuple[str, int], ...]

    @functools.cached_property
    def _rank_map(self) -> dict[str, int]:
        return dict(self.ranks)

    def rank_of(self, path: str) -> int | None:
        return self._rank_map.get(path)

    def as_dict(self) -> dict[str, int]:
        return dict(self._rank_map)


NO_COMPRESSION = CompressionPlan(ranks=())


def make_plan(policy: str, leaves: list[LeafInfo],
              stage_ranks: list[int] | None = None, fixed_rank: int = 64,
              num_stages: int = 1) -> CompressionPlan:
    """Build the per-leaf rank plan for a policy (see module docstring)."""
    if policy == "none":
        return NO_COMPRESSION
    if policy == "edgc":
        if stage_ranks is None:
            raise ValueError("edgc plan needs DAC stage ranks")
        if len(stage_ranks) != num_stages:
            raise ValueError(
                f"stage_ranks has {len(stage_ranks)} entries for "
                f"num_stages={num_stages}; Algorithm 2 must emit one rank "
                f"per pipeline stage")
    ranks: list[tuple[str, int]] = []
    for info in leaves:
        if not info.eligible:
            continue
        max_r = min(info.shape[-2:]) // 2
        if policy == "fixed":
            r = fixed_rank
        elif policy == "optimus":
            boundary = info.stage in (0, num_stages - 1)
            r = min(fixed_rank * 2, max_r) if boundary else fixed_rank
        elif policy == "edgc":
            r = stage_ranks[info.stage]
        else:
            raise ValueError(f"unknown policy {policy!r}")
        r = max(1, min(r, max_r))
        ranks.append((info.path, int(r)))
    return CompressionPlan(ranks=tuple(ranks))


def init_compressor_state(params: Any, plan: CompressionPlan, seed: int, *,
                          layout: BucketLayout | None = None,
                          wire_ef: bool = False) -> dict[str, LowRankState]:
    """Compressor state for a plan.

    One LowRankState per compressed leaf keyed by path (per-leaf executor),
    or, with a ``layout``, the same warm starts stacked into one fp32 state
    per shape group (bucketed executor). ``wire_ef`` (coded wire modes)
    adds a zero fp32 residual per flat-bucket member (``ef:<path>``).
    """
    by_path = dict(tree.flatten_with_path(params))
    state: dict[str, LowRankState] = {}
    for i, (path, rank) in enumerate(plan.ranks):
        leaf = by_path[path]
        state[path] = init_leaf_state(tuple(leaf.shape), rank, fold_in(seed, i),
                                      leaf.dtype, leaf.device)
    if layout is None:
        return state
    state = bucketing.stack_state(state, layout)
    if wire_ef:
        device = next(iter(by_path.values())).device
        state.update(bucketing.init_flat_ef(layout, device))
    return state


def resize_compressor_state(state: dict[str, LowRankState],
                            plan: CompressionPlan, seed: int, *,
                            old_layout: BucketLayout | None = None,
                            new_layout: BucketLayout | None = None,
                            device="cpu") -> dict[str, LowRankState]:
    """Migrate warm-start Q / EF buffers when DAC changes ranks or leaves."""
    if old_layout is not None or bucketing.is_stacked_state(state):
        if old_layout is None or new_layout is None:
            raise ValueError("stacked compressor state needs old_layout and "
                             "new_layout to resize")
        return bucketing.resize_stacked_state(state, old_layout, new_layout,
                                              seed, device)
    new_state: dict[str, LowRankState] = {}
    for i, (path, rank) in enumerate(plan.ranks):
        if path not in state:
            raise KeyError(f"no compressor state for newly-compressed leaf {path}")
        new_state[path] = resize_rank(state[path], rank, fold_in(seed, i))
    return new_state


@torch.no_grad()
def sync_grads(grads: Any, comp_state: dict[str, LowRankState],
               plan: CompressionPlan, psum_mean: PsumFn,
               use_kernels: bool = False, bucketed: bool | None = None,
               bucket_bytes: int = DEFAULT_BUCKET_BYTES, codec=None,
               donate: bool = False):
    """Data-parallel gradient synchronization under a compression plan.

    ``bucketed=False`` runs the per-leaf loop (parity oracle: two factor
    psums per compressed leaf, one psum per other leaf); ``bucketed=True``
    the shape-grouped schedule of ``bucketing``; ``None`` infers it from
    the state format. ``codec`` (``wire.ChunkCodec``) codes every
    collective payload, bucketed executor only. ``donate`` (bucketed
    executor) writes the new EF residuals into ``comp_state``'s buffers
    (``bucketing.bucketed_sync_grads``). Returns (synced grads, new
    compressor state).

    Tensor parallelism: gradients and compressor state that are DTensors
    (each placed as its parameter, no ``Partial`` left) sync through
    ``_sync_tp`` on their local shards.
    """
    if bucketed is None:
        bucketed = bucketing.is_stacked_state(comp_state)
    if codec is not None and not bucketed:
        raise ValueError("wire coding (codec) requires the bucketed executor; "
                         "the per-leaf path is the raw parity oracle")
    if any(isinstance(g, DTensor) for g in tree.leaves(grads)):
        return _sync_tp(grads, comp_state, plan, psum_mean, use_kernels,
                        bucketed, bucket_bytes, codec, donate)
    if bucketed:
        layout = bucketing.layout_for_tree(grads, plan, bucket_bytes)
        return bucketing.bucketed_sync_grads(grads, comp_state, layout,
                                             psum_mean, use_kernels=use_kernels,
                                             codec=codec, donate=donate)
    rank_by_path = plan.as_dict()
    flat = tree.flatten_with_path(grads)
    out_leaves = []
    new_state = dict(comp_state)
    for path, g in flat:
        if path in rank_by_path:
            g_hat, st = compress_leaf(g, comp_state[path], psum_mean,
                                      use_kernels=use_kernels)
            new_state[path] = st
            out_leaves.append(g_hat)
        else:
            out_leaves.append(psum_mean(g))
    return tree.unflatten(grads, out_leaves), new_state


def _sync_tp(grads, comp_state, plan, psum_mean, use_kernels, bucketed,
             bucket_bytes, codec, donate):
    """The sync of DTensor gradients (the ``dp_tp`` step on a ``model``
    axis). The bucketed executor runs at model size 1 only
    (``bucketing.bucketing_supported``), where a shard is the whole leaf:
    it syncs the local tensors. The per-leaf executor runs every leaf in
    sorted-path order on every process: compressed leaves through
    ``compress_leaf_tp`` by where the parameter is split, the others
    through the DP mean of the local shard."""
    like = next(g for g in tree.leaves(grads) if isinstance(g, DTensor))
    mesh = like.device_mesh
    local_state = lambda st: (type(st)(*(tp.local(t) for t in st))
                              if isinstance(st, LowRankState) else tp.local(st))
    rewrap_state = lambda old, new: (
        type(old)(*(tp.rewrap(o, n) for o, n in zip(old, new)))
        if isinstance(old, LowRankState) else tp.rewrap(old, new))
    if bucketed:
        if tp.model_size(mesh) != 1:
            raise ValueError("the bucketed sync needs model size 1 "
                             "(bucketing_supported); use bucketed=False")
        synced, new = sync_grads(
            tree.tree_map(tp.local, grads),
            {k: local_state(v) for k, v in comp_state.items()}, plan,
            psum_mean, use_kernels, True, bucket_bytes, codec, donate)
        return (tree.tree_map(tp.rewrap, grads, synced),
                {k: rewrap_state(comp_state[k], v) for k, v in new.items()})
    group = mesh.get_group("model")
    index = mesh.get_local_rank("model")
    model_psum = make_model_psum(group)
    gather = lambda t, dim: model_all_gather(t, dim, group)
    rank_by_path = plan.as_dict()
    out_leaves = []
    new_state = dict(comp_state)
    for path, g in tree.flatten_with_path(grads):
        if path in rank_by_path:
            st = comp_state[path]
            g_hat, new = compress_leaf_tp(
                tp.local(g), local_state(st), tp.shard_dim(g), index,
                psum_mean, model_psum, gather, use_kernels=use_kernels)
            new_state[path] = rewrap_state(st, new)
            out_leaves.append(tp.rewrap(g, g_hat))
        else:
            out_leaves.append(tp.rewrap(g, psum_mean(tp.local(g))))
    return tree.unflatten(grads, out_leaves), new_state


def plan_wire_bytes(leaves: list[LeafInfo], plan: CompressionPlan,
                    bytes_per_elem: int = 2, codec=None) -> tuple[int, int]:
    """(compressed_bytes, full_bytes) moved per step by the DP sync.

    With a ``codec`` the compressed bytes are the coded payloads (packed
    words + scales of the factor elements and of each uncompressed leaf);
    ``full_bytes`` stays the raw uncoded baseline either way.
    """
    comp, full = 0, 0
    for c, f in leaf_wire_bytes(leaves, plan, bytes_per_elem, codec):
        comp += c
        full += f
    return comp, full


def leaf_wire_bytes(leaves: list[LeafInfo], plan: CompressionPlan,
                    bytes_per_elem: int = 2, codec=None):
    """Yields (compressed, full) DP-sync bytes of each leaf, in order."""
    rank_by_path = plan.as_dict()
    for info in leaves:
        nelem = 1
        for d in info.shape:
            nelem *= d
        if info.path in rank_by_path:
            rank = rank_by_path[info.path]
            if codec is not None:
                comp = _wire.coded_bytes(compressed_bytes(info.shape, rank, 1),
                                         codec)
            else:
                comp = compressed_bytes(info.shape, rank, bytes_per_elem)
        elif codec is not None:
            comp = _wire.coded_bytes(nelem, codec)
        else:
            comp = nelem * bytes_per_elem
        yield comp, nelem * bytes_per_elem
