"""Path-based partition rules for ``("pod", "data", "model")`` meshes.

Port of ``repro/dist/sharding.py``. A spec is a tuple of entries, one per
leading tensor dim: ``None`` (unsharded), an axis name, or a tuple of axis
names; entry for entry the reference's ``PartitionSpec``. The rules key on
the leaf's ``keystr`` path (``['stages'][0]['blocks']['attn']['wq']``),
which :mod:`repro_torch.tree` renders as the reference does:

  * column-parallel (the output, last dim): wq/wk/wv, mlp up/gate, ssm
    in_proj / up_x / up_z, lm_head;
  * row-parallel (the input, second-to-last dim): wo, mlp down, out_proj;
  * expert-parallel: MoE ``experts`` stacks (..., E, d, f) on the E dim;
  * vocab-parallel: token embeddings on dim 0;
  * replicated: norms, biases, scales, routers, convs, SSM time constants
    and positional tables.

A dim the model-axis size does not divide stays unsharded (the
divisibility guard). ``apply_fsdp`` adds the data axes to large leaves,
``batch_pspec`` shards a batch's leading dim and ``cache_pspecs`` a decode
cache. Every function takes a ``DeviceMesh`` or a dict of axis sizes.

``to_placements`` turns a spec into DTensor placements on a mesh and
``distribute_tree`` places a tree of full tensors: each process keeps its
own chunk, cut locally (every process holds the same full tensors, drawn
from one seed), so placing moves no data.
"""
from __future__ import annotations

import math
import re
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import tree

__all__ = ["apply_fsdp", "axis_sizes", "batch_pspec", "cache_pspecs",
           "contiguous_stride", "distribute", "distribute_tree", "local_chunk",
           "param_pspecs", "param_specs", "spec_leaves", "stage_param_pspecs",
           "to_placements"]

Spec = tuple

# The reference's regexes, character for character.
_REPLICATED = re.compile(
    r"norm|bias|scale|router|conv|a_log|\bdt\b|pos", re.IGNORECASE
)
_COLUMN = re.compile(r"\b(wq|wk|wv|up|gate|in_proj|up_x|up_z|lm_head)\b")
_ROW = re.compile(r"\b(wo|down|out_proj)\b")


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a dict of sizes."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dp_prefix(mesh) -> tuple[str, ...]:
    """The ("pod", "data") axes present on this mesh, pod-major."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _spec_for(path: str, shape: tuple[int, ...], mesh) -> Spec:
    """The spec of one parameter leaf, with the divisibility guard."""
    sizes = axis_sizes(mesh)
    msize = sizes.get("model", 1)
    ndim = len(shape)
    if ndim < 2 or "model" not in sizes:
        return ()
    if _REPLICATED.search(path):
        return ()

    entries: list[Any] = [None] * ndim

    def shard(dim: int) -> Spec:
        if shape[dim] % msize == 0:
            entries[dim] = "model"
        return tuple(entries)

    if "experts" in path and ndim >= 3:
        return shard(ndim - 3)          # (..., E, d, f): expert dim
    if "embed" in path:
        return shard(0)                 # (V, d): vocab-parallel
    if _COLUMN.search(path):
        return shard(ndim - 1)
    if _ROW.search(path):
        return shard(ndim - 2)
    return ()


def _specs_by_path(fn, params: Any) -> Any:
    flat = tree.flatten_with_path(params)
    return tree.unflatten(params, [fn(p, tuple(l.shape)) for p, l in flat])


def param_pspecs(params: Any, mesh) -> Any:
    """The spec tree of a parameter tree (the TP rules only)."""
    return _specs_by_path(lambda p, s: _spec_for(p, s, mesh), params)


def stage_param_pspecs(stacked: Any, mesh) -> Any:
    """Specs of a stage-stacked tree: dim 0 over ``pipe`` (None without
    that axis), the other dims by the TP rules of the leaf's path."""
    has_pipe = "pipe" in axis_sizes(mesh)

    def one(path: str, shape: tuple[int, ...]) -> Spec:
        inner = _spec_for(path, shape[1:], mesh)
        entries = list(inner) + [None] * (len(shape) - 1 - len(inner))
        return ("pipe" if has_pipe else None, *entries)

    return _specs_by_path(one, stacked)


def apply_fsdp(specs: Any, params: Any, mesh, axes,
               min_size: int = 1 << 20) -> Any:
    """Add ``axes`` to big leaves (ZeRO-3 weight sharding): every leaf of at
    least ``min_size`` elements whose spec does not use them yet takes
    them on its first unsharded dim that their total size divides."""
    axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = axis_sizes(mesh)
    n = math.prod(sizes.get(a, 1) for a in axes_t)
    entry = axes_t[0] if len(axes_t) == 1 else axes_t

    def one(spec: Spec, leaf) -> Spec:
        shape = tuple(leaf.shape)
        if not axes_t or n <= 1 or math.prod(shape) < min_size:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for e in entries:
            used.update(e if isinstance(e, tuple) else (e,))
        if used.intersection(axes_t):
            return spec
        for i, d in enumerate(shape):
            if entries[i] is None and d % n == 0:
                entries[i] = entry
                return tuple(entries)
        return spec

    return tree.unflatten(params, [one(s, l) for s, l in
                                   zip(spec_leaves(specs), tree.leaves(params))])


def spec_leaves(specs: Any) -> list[Spec]:
    """The specs of a spec tree, in order (a spec is a tuple leaf)."""
    out: list[Spec] = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            out.append(tuple(node))

    walk(specs)
    return out


def param_specs(params: Any, mesh, fsdp: bool = False) -> Any:
    """TP specs, plus FSDP over the ("pod", "data") axes with ``fsdp``."""
    specs = param_pspecs(params, mesh)
    if fsdp:
        specs = apply_fsdp(specs, params, mesh, _dp_prefix(mesh))
    return specs


def _batch_entry(batch_size: int, mesh):
    """The entry of a global-batch dim: the longest ("pod", "data") prefix
    whose total size divides the batch, pod-major."""
    sizes = axis_sizes(mesh)
    axes = _dp_prefix(mesh)
    while axes:
        n = math.prod(sizes[a] for a in axes)
        if batch_size % n == 0:
            return axes[0] if len(axes) == 1 else axes
        axes = axes[:-1]
    return None


def batch_pspec(ndim: int, mesh, batch_size: int) -> Spec:
    """Batch-dim-leading spec of an input of rank ``ndim``."""
    if ndim == 0:
        return ()
    return (_batch_entry(batch_size, mesh), *([None] * (ndim - 1)))


_LAST_KEY = re.compile(r"\[(?:'([^']*)'|(\d+))\]$")


def _last_key(path: str) -> str:
    """The last key of a ``keystr`` path as the reference names it: a dict
    key or a list index; "" for a named-tuple field."""
    m = _LAST_KEY.search(path)
    if m is None:
        return ""
    return m.group(1) if m.group(1) is not None else m.group(2)


def cache_pspecs(cache: Any, mesh, batch_size: int) -> Any:
    """Specs of a decode cache: K/V leaves (..., B, C, Hkv, hd) shard the
    batch over the data axes and the kv heads over ``model``; other leaves
    are batch-major; scalars stay replicated."""
    sizes = axis_sizes(mesh)
    msize = sizes.get("model", 1)
    dp_entry = _batch_entry(batch_size, mesh)

    def one(path: str, shape: tuple[int, ...]) -> Spec:
        if not shape:
            return ()
        entries: list[Any] = [None] * len(shape)
        if _last_key(path) in ("k", "v") and len(shape) >= 4:
            if shape[len(shape) - 4] == batch_size:
                entries[len(shape) - 4] = dp_entry
            if msize > 1 and shape[-2] % msize == 0:
                entries[-2] = "model"
        elif shape[0] == batch_size:
            entries[0] = dp_entry
        return tuple(entries)

    return _specs_by_path(one, cache)


# ------------------------------------------------------------ DTensor side
def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that entry ``d`` names, ``Replicate()`` on the others. A
    tensor dim split over several axes is split in the entry's order,
    major first, as the reference's mesh lays it out."""
    names = mesh.mesh_dim_names
    out: list[Any] = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not on the "
                                 f"mesh {names}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_chunk(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This process's chunk of the full tensor ``t`` under ``placements``."""
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if t.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"split over {n}")
            t = t.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
    return t


def distribute(t: torch.Tensor, placements, mesh) -> DTensor:
    """A DTensor of the full tensor ``t`` that every process holds."""
    local = local_chunk(t, placements, mesh)
    if local.shape != t.shape or not local.is_contiguous():
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=contiguous_stride(t.shape))


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def distribute_tree(tree_: Any, specs: Any, mesh) -> Any:
    """``tree_``'s full tensors as DTensors placed by the spec tree."""
    return tree.unflatten(tree_, [
        distribute(t, to_placements(s, mesh), mesh)
        for t, s in zip(tree.leaves(tree_), spec_leaves(specs))])
