"""Bucketed DP gradient sync: shape-grouped stacked compression + flat buckets.

Port of ``repro/core/bucketing.py``. The per-leaf loop
issues one collective per uncompressed leaf and two per compressed leaf;
this schedule issues two per shape group and one per flat bucket:

  * **Shape groups** — compressed leaves sharing a matricized (m, n) and a
    plan rank are stacked into one fp32 (E, m, n) batch and synced by one
    batched PowerSGD round (two factor collectives).
  * **Flat buckets** — the other leaves are packed in tree order into
    size-capped buckets, each moved by one collective.

The :class:`BucketLayout` is a pure function of (leaf shapes, plan, cap),
so the host derives the same layout at init, at each step and at DAC
re-plans. Stacked compressor state lives in fp32 under ``group:MxN:r`` keys.

With a wire codec (``core/wire.py``) every collective payload is coded:
the factor collectives through ``wire.coded_psum`` (the error lands in
the PowerSGD residual), and each flat-bucket member on its own, with an
fp32 error-feedback residual under ``ef:<path>`` in the compressor state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable

import torch

from repro_torch import tree
from . import wire as _wire
from .config import DEFAULT_BUCKET_BYTES
from .powersgd import (LowRankState, compress_leaf, fold_in, init_leaf_state,
                       resize_rank)

__all__ = [
    "DEFAULT_BUCKET_BYTES", "ShapeGroup", "FlatBucket", "BucketLayout",
    "SyncChunk", "make_bucket_layout", "layout_for_tree", "sync_chunks",
    "is_stacked_state", "init_flat_ef", "stack_state", "unstack_state",
    "resize_stacked_state", "bucketed_sync_grads", "sync_chunk_grads",
    "bucketing_supported",
]

PsumFn = Callable[[torch.Tensor], torch.Tensor]

GROUP_PREFIX = "group:"             # stacked-state dict keys start with this
EF_PREFIX = "ef:"                   # flat-bucket wire-EF state keys
F32 = torch.float32

Member = tuple[str, tuple[int, ...]]    # (leaf path, original leaf shape)


def _batch_of(shape: tuple[int, ...]) -> int:
    """Number of (m, n) slices a leaf contributes to its group's stack."""
    return math.prod(shape[:-2]) if len(shape) > 2 else 1


def _numel(shape: tuple[int, ...]) -> int:
    return math.prod(shape) if shape else 1


@dataclasses.dataclass(frozen=True)
class ShapeGroup:
    """All compressed leaves sharing matricized shape (m, n) and rank."""

    m: int
    n: int
    rank: int
    members: tuple[Member, ...]     # stack order = tree-flatten order

    @property
    def key(self) -> str:
        return f"{GROUP_PREFIX}{self.m}x{self.n}:r{self.rank}"

    @property
    def stack_size(self) -> int:
        return sum(_batch_of(shape) for _, shape in self.members)


@dataclasses.dataclass(frozen=True)
class FlatBucket:
    """Uncompressed leaves packed into one flat all-reduce.

    ``itemsizes`` parallels ``members`` (4 when derived from shapes alone);
    the bucket moves in the widest member dtype.
    """

    members: tuple[Member, ...]
    itemsizes: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static, hashable sync schedule: stacked groups + flat buckets."""

    groups: tuple[ShapeGroup, ...]
    buckets: tuple[FlatBucket, ...]
    chunk_bytes: int = 0

    def num_collectives(self) -> int:
        """Collectives per step: two factor psums per group, one per bucket."""
        return 2 * len(self.groups) + len(self.buckets)


@dataclasses.dataclass(frozen=True)
class SyncChunk:
    """One independently-launchable slice of a bucketed sync schedule.

    Either one whole shape group (its factor collectives and error
    feedback act on the full stack) or a member run of one flat bucket.
    Chunks partition the layout's leaves, so running every chunk, in any
    order, reproduces ``bucketed_sync_grads`` bit for bit: a mean of a
    packed sub-run equals the matching slice of the whole bucket's mean.
    """

    kind: str                           # "group" | "bucket"
    group: ShapeGroup | None = None
    members: tuple[Member, ...] = ()
    itemsizes: tuple[int, ...] = ()

    @property
    def member_paths(self) -> tuple[str, ...]:
        src = self.group.members if self.kind == "group" else self.members
        return tuple(path for path, _ in src)

    @property
    def num_collectives(self) -> int:
        return 2 if self.kind == "group" else 1

    def wire_bytes(self, bytes_per_elem: int | None = None,
                   codec: _wire.ChunkCodec | None = None) -> int:
        """Collective payload bytes (factor collectives / packed bucket).

        Raw: group chunks move fp32 factors; bucket chunks move the widest
        member dtype (``bytes_per_elem`` overrides both). With ``codec``,
        the coded size, per member for buckets (scale groups never span
        members).
        """
        if self.kind == "group":
            g = self.group
            n_elems = (g.m + g.n) * g.rank * g.stack_size
            if codec is not None:
                return _wire.coded_bytes(n_elems, codec)
            return n_elems * (4 if bytes_per_elem is None else bytes_per_elem)
        if codec is not None:
            return sum(_wire.coded_bytes(_numel(shape), codec)
                       for _, shape in self.members)
        if bytes_per_elem is None:
            bytes_per_elem = max(self.itemsizes) if self.itemsizes else 4
        return sum(_numel(shape) for _, shape in self.members) * bytes_per_elem


def sync_chunks(layout: BucketLayout) -> tuple[SyncChunk, ...]:
    """Split a layout into launchable chunks (groups first, tree order).

    Flat buckets split into member runs capped at ``layout.chunk_bytes`` of
    fp32 payload; ``chunk_bytes == 0`` keeps one chunk per bucket.
    """
    chunks = [SyncChunk(kind="group", group=g) for g in layout.groups]
    cap_elems = max(1, layout.chunk_bytes // 4) if layout.chunk_bytes > 0 else 0
    for bucket in layout.buckets:
        sizes = bucket.itemsizes or (4,) * len(bucket.members)
        if cap_elems <= 0:
            chunks.append(SyncChunk(kind="bucket", members=bucket.members,
                                    itemsizes=tuple(sizes)))
            continue
        run: list[Member] = []
        run_sizes: list[int] = []
        run_elems = 0
        for (path, shape), isz in zip(bucket.members, sizes):
            nelem = _numel(shape)
            if run and run_elems + nelem > cap_elems:
                chunks.append(SyncChunk(kind="bucket", members=tuple(run),
                                        itemsizes=tuple(run_sizes)))
                run, run_sizes, run_elems = [], [], 0
            run.append((path, shape))
            run_sizes.append(isz)
            run_elems += nelem
        if run:
            chunks.append(SyncChunk(kind="bucket", members=tuple(run),
                                    itemsizes=tuple(run_sizes)))
    return tuple(chunks)


def make_bucket_layout(leaves: Iterable[Any], plan,
                       bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                       chunk_bytes: int = 0) -> BucketLayout:
    """Derive the bucketed sync schedule from leaf shapes and a plan.

    ``leaves`` holds ``LeafInfo``s, ``(path, shape)`` pairs or
    ``(path, shape, itemsize)`` triples in tree-flatten order.
    """
    pairs: list[Member] = []
    size_of: dict[str, int] = {}
    for leaf in leaves:
        if isinstance(leaf, tuple):
            path, shape = leaf[0], leaf[1]
            isz = leaf[2] if len(leaf) > 2 else None
        else:
            path, shape = leaf.path, leaf.shape
            isz = getattr(leaf, "itemsize", None)
        pairs.append((path, tuple(shape)))
        size_of[path] = int(isz) if isz else 4  # lint: allow(host-call-in-hot-path) host-side planner, a static itemsize

    rank_by_path = plan.as_dict()
    grouped: dict[tuple[int, int, int], list[Member]] = {}
    buckets: list[FlatBucket] = []
    pending: list[Member] = []
    pending_elems = 0
    cap_elems = max(1, bucket_bytes // 4)   # cap assumes 4 B/elem (widest)

    def _flush(run: list[Member]) -> FlatBucket:
        return FlatBucket(members=tuple(run),
                          itemsizes=tuple(size_of[p] for p, _ in run))

    for path, shape in pairs:
        if path in rank_by_path:
            m, n = shape[-2:]
            grouped.setdefault((m, n, rank_by_path[path]), []).append((path, shape))
        else:
            nelem = _numel(shape)
            if pending and pending_elems + nelem > cap_elems:
                buckets.append(_flush(pending))
                pending, pending_elems = [], 0
            pending.append((path, shape))
            pending_elems += nelem
    if pending:
        buckets.append(_flush(pending))

    groups = tuple(ShapeGroup(m=m, n=n, rank=r, members=tuple(members))
                   for (m, n, r), members in grouped.items())
    return BucketLayout(groups=groups, buckets=tuple(buckets),
                        chunk_bytes=chunk_bytes)


def layout_for_tree(grads: Any, plan, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                    chunk_bytes: int = 0) -> BucketLayout:
    """Layout from a gradient/param tree."""
    return make_bucket_layout(
        [(path, tuple(t.shape), t.element_size())
         for path, t in tree.flatten_with_path(grads)],
        plan, bucket_bytes, chunk_bytes)


def is_stacked_state(state: dict) -> bool:
    """True iff ``state`` is keyed by shape groups rather than leaf paths
    (``ef:`` entries exist only in the bucketed format, so they count)."""
    return any(k.startswith((GROUP_PREFIX, EF_PREFIX)) for k in state)


def init_flat_ef(layout: BucketLayout, device="cpu") -> dict[str, torch.Tensor]:
    """Zero fp32 error-feedback residuals (``ef:<path>``) for every
    flat-bucket member: the coded ``_sync_flat`` adds each back into the
    next step's payload before quantizing."""
    return {EF_PREFIX + path: torch.zeros(shape, dtype=F32, device=device)
            for bucket in layout.buckets for path, shape in bucket.members}


def bucketing_supported(mesh) -> bool:
    """Whether the bucketed executor serves this mesh: model size 1 only.
    Stacked group state mixes leaves with different TP splits in one
    array, so its EF would be replicated over ``model``, and adding it
    would gather every split gradient (the reference's rule)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return True
    return mesh.size(mesh.mesh_dim_names.index("model")) == 1


# ------------------------------------------------------------ state plumbing
def stack_state(per_leaf: dict[str, LowRankState],
                layout: BucketLayout) -> dict[str, LowRankState]:
    """Per-leaf states -> one fp32 (E, ., .) LowRankState per shape group."""
    stacked: dict[str, LowRankState] = {}
    for group in layout.groups:
        qs, errs = [], []
        for path, _ in group.members:
            st = per_leaf[path]
            qs.append(st.q.to(F32).reshape(-1, group.n, st.q.shape[-1]))
            errs.append(st.err.to(F32).reshape(-1, group.m, group.n))
        stacked[group.key] = LowRankState(q=torch.cat(qs, dim=0),
                                          err=torch.cat(errs, dim=0))
    return stacked


def unstack_state(stacked: dict[str, LowRankState],
                  layout: BucketLayout) -> dict[str, LowRankState]:
    """Inverse of :func:`stack_state` (per-leaf states come back in fp32)."""
    per_leaf: dict[str, LowRankState] = {}
    for group in layout.groups:
        st = stacked[group.key]
        rank = st.q.shape[-1]
        offset = 0
        for path, shape in group.members:
            e = _batch_of(shape)
            q = st.q[offset:offset + e]
            err = st.err[offset:offset + e].reshape(shape)
            q = q[0] if len(shape) == 2 else q.reshape(tuple(shape[:-2]) + (group.n, rank))
            per_leaf[path] = LowRankState(q=q, err=err)
            offset += e
    return per_leaf


def resize_stacked_state(stacked: dict[str, LowRankState],
                         old_layout: BucketLayout, new_layout: BucketLayout,
                         seed: int, device) -> dict[str, LowRankState]:
    """Migrate stacked state across a DAC re-plan (window boundary).

    Previously-compressed leaves keep their warm-start Q (leading columns on
    shrink, fresh random tail columns on grow) and their EF residual; leaves
    entering compression get a fresh ``init_leaf_state``. If the old state
    carries ``ef:`` entries, the new one gets one per new-layout bucket
    member: kept where the member stayed flat, zeros where it left a group.
    """
    per_leaf = unstack_state(stacked, old_layout)
    new_per_leaf: dict[str, LowRankState] = {}
    i = 0
    for group in new_layout.groups:
        for path, shape in group.members:
            sub = fold_in(seed, i)
            i += 1
            if path in per_leaf:
                new_per_leaf[path] = resize_rank(per_leaf[path], group.rank, sub)
            else:
                new_per_leaf[path] = init_leaf_state(shape, group.rank, sub,
                                                     F32, device)
    new_state: dict[str, Any] = stack_state(new_per_leaf, new_layout)
    if any(k.startswith(EF_PREFIX) for k in stacked):
        for k, zeros in init_flat_ef(new_layout, device).items():
            new_state[k] = stacked.get(k, zeros)
    return new_state


# ------------------------------------------------------------- sync executor
def _sync_group(by_path: dict[str, torch.Tensor], group: ShapeGroup,
                state: LowRankState, psum_mean: PsumFn,
                use_kernels: bool = False,
                codec: _wire.ChunkCodec | None = None):
    """One shape group: concat -> stacked PowerSGD (2 psums) -> slice back.

    With a codec the factor collectives ship coded P/Q; the error lands in
    the PowerSGD residual.
    """
    stack = torch.cat([by_path[path].to(F32).reshape(-1, group.m, group.n)
                       for path, _ in group.members], dim=0)
    g_hat, st = compress_leaf(stack, state, _wire.coded_psum(psum_mean, codec),
                              use_kernels=use_kernels)
    out: dict[str, torch.Tensor] = {}
    offset = 0
    for path, shape in group.members:
        e = _batch_of(shape)
        out[path] = (g_hat[offset:offset + e].reshape(shape)
                     .to(by_path[path].dtype))
        offset += e
    return out, st


def _sync_flat(by_path: dict[str, torch.Tensor], members: tuple[Member, ...],
               psum_mean: PsumFn, codec: _wire.ChunkCodec | None = None,
               comp_state: dict | None = None):
    """One flat member run: [code ->] pack -> psum-mean -> slice back.

    The run moves in the widest member dtype. With a codec each member goes
    through the wire round trip on its own, its residual ``ef:<path>``
    (when ``comp_state`` has one) added before coding and replaced by
    what coding lost. Returns (synced leaves, EF-state updates).
    """
    wire_dtype = by_path[members[0][0]].dtype
    for path, _ in members[1:]:
        wire_dtype = torch.promote_types(wire_dtype, by_path[path].dtype)
    parts: list[torch.Tensor] = []
    ef_out: dict[str, torch.Tensor] = {}
    for path, _ in members:
        g = by_path[path]
        if codec is None:
            parts.append(g.to(wire_dtype).reshape(-1))
            continue
        v = g.to(F32).reshape(-1)
        ef = (comp_state or {}).get(EF_PREFIX + path)
        if ef is not None:
            v = v + ef.to(F32).reshape(-1)
        sent = _wire.roundtrip(v, codec).to(wire_dtype)
        if ef is not None:
            ef_out[EF_PREFIX + path] = (v - sent.to(F32)).reshape(g.shape)
        parts.append(sent)
    packed = psum_mean(torch.cat(parts))
    out: dict[str, torch.Tensor] = {}
    offset = 0
    for path, shape in members:
        nelem = _numel(shape)
        out[path] = (packed[offset:offset + nelem].reshape(shape)
                     .to(by_path[path].dtype))
        offset += nelem
    return out, ef_out


@torch.no_grad()
def bucketed_sync_grads(grads: Any, comp_state: dict[str, LowRankState],
                        layout: BucketLayout, psum_mean: PsumFn,
                        use_kernels: bool = False,
                        codec: _wire.ChunkCodec | None = None,
                        donate: bool = False):
    """Execute the bucketed schedule: 2 psums per group, 1 per flat bucket,
    every payload coded when ``codec`` is given.

    ``donate``: the caller gives up ``comp_state``'s residuals. Each
    group's new EF residual (and each coded member's ``ef:`` residual) is
    copied into the old one's buffer as soon as it is computed, so the old
    and the new residuals of the whole tree are never held at once; the
    values returned are the same."""
    flat = tree.flatten_with_path(grads)
    by_path = dict(flat)
    out: dict[str, torch.Tensor] = {}
    new_state = dict(comp_state)
    for group in layout.groups:
        upd, st = _sync_group(by_path, group, comp_state[group.key], psum_mean,
                              use_kernels=use_kernels, codec=codec)
        out.update(upd)
        if donate:
            st = LowRankState(q=st.q, err=comp_state[group.key].err.copy_(st.err))
        new_state[group.key] = st
    for bucket in layout.buckets:
        upd, ef_upd = _sync_flat(by_path, bucket.members, psum_mean,
                                 codec=codec, comp_state=comp_state)
        out.update(upd)
        if donate:
            ef_upd = {k: comp_state[k].copy_(v) for k, v in ef_upd.items()}
        new_state.update(ef_upd)
    return tree.unflatten(grads, [out[path] for path, _ in flat]), new_state


@torch.no_grad()
def sync_chunk_grads(grads_by_path: dict[str, torch.Tensor],
                     comp_state: dict[str, LowRankState], chunk: SyncChunk,
                     psum_mean: PsumFn, use_kernels: bool = False,
                     codec: _wire.ChunkCodec | None = None):
    """Execute one chunk of a layout's schedule (the overlap primitive).

    ``grads_by_path`` needs only the chunk's members. Returns the synced
    leaves by path and the state entries the chunk touched: ``{group key:
    new state}`` for a group chunk, the coded run's ``ef:`` updates for a
    flat run. These are the helpers ``bucketed_sync_grads`` runs, and
    coding is per member, so the chunks of a layout partition its state.
    """
    if chunk.kind == "group":
        upd, st = _sync_group(grads_by_path, chunk.group,
                              comp_state[chunk.group.key], psum_mean,
                              use_kernels=use_kernels, codec=codec)
        return upd, {chunk.group.key: st}
    return _sync_flat(grads_by_path, chunk.members, psum_mean, codec=codec,
                      comp_state=comp_state)
