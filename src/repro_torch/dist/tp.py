"""Tensor parallelism over DTensor: the helpers the step, the sync, the
entropy sample and the optimizer share.

The parameters of a run on a mesh with a ``model`` axis are DTensors
placed by ``dist.sharding``'s rules (on the ``model`` sub-mesh in the
``dp_tp`` step, on the whole ``(data, model)`` mesh in ``auto``). The
forward runs under :func:`model_context`, where DTensor's sharding
propagation plays the part of GSPMD's AUTO axis and plain tensors made
inside the model (positions, masks) count as replicated. Everything after
the gradients works on the local shards (``local``): the kernels are
ctypes launches on ``data_ptr()`` and never see a DTensor, and the sums
that GSPMD inserts in the reference are explicit collectives over the
mesh dims a leaf is split on (``sharded_dims``, ``leafwise_sums``), issued in
one order on every process.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist.sharding import contiguous_stride

__all__ = ["BatchSplit", "gather_unless_divides", "leafwise_sums", "local",
           "local_heads", "local_map", "model_context", "model_size",
           "normalize_grad", "rewrap", "shard_dim", "sharded_dims",
           "split_rows_for"]


def model_size(mesh) -> int:
    """Size of the mesh's ``model`` axis (1 without one)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("model"))


@contextlib.contextmanager
def model_context(active: bool = True):
    """Run a model whose parameters are DTensors: plain tensors made
    inside count as replicated on the mesh. Contexts nest (torch's own
    ``implicit_replication`` clears the flag on exit, so an inner one
    would end an outer one's)."""
    if not active:
        yield
        return
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def local(t):
    """The local shard of a DTensor (a view of its storage), else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def rewrap(like: Any, t: torch.Tensor):
    """``t`` (a local shard shaped as ``like``'s) as a DTensor placed as
    ``like``; ``t`` itself when ``like`` is a plain tensor."""
    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def shard_dim(t, mesh_dim: str = "model") -> int | None:
    """The tensor dim a DTensor splits over ``mesh_dim`` (None if none)."""
    if not isinstance(t, DTensor):
        return None
    names = t.device_mesh.mesh_dim_names
    if mesh_dim not in names:
        return None
    p = t.placements[names.index(mesh_dim)]
    return p.dim if isinstance(p, Shard) else None


def sharded_dims(t) -> tuple[str, ...]:
    """The mesh dims a DTensor is split over, in mesh order."""
    if not isinstance(t, DTensor):
        return ()
    return tuple(n for n, p in zip(t.device_mesh.mesh_dim_names,
                                   t.placements) if isinstance(p, Shard))


def normalize_grad(g, like):
    """A gradient placed as its parameter ``like``: DTensor's backward
    hands back ``Partial`` sums or other splits, which must not reach the
    sync or the optimizer."""
    if not isinstance(like, DTensor):
        return g
    if not isinstance(g, DTensor):
        return rewrap(like, g)
    if tuple(g.placements) != tuple(like.placements):
        g = g.redistribute(like.device_mesh, like.placements)
    return g


def leafwise_sums(values: list[torch.Tensor], likes: list) -> list[torch.Tensor]:
    """Per-leaf global sums of local partial sums: ``values[i]`` (0-d) is
    this process's sum over its shard of leaf ``likes[i]`` (a DTensor, or
    a plain tensor held whole). Each value is summed over the mesh dims its
    leaf is split on, every leaf's in one all-reduce per mesh dim: a value
    not split on that dim enters from the dim's first process only. Plain
    leaves come back as given, so a caller that adds the returned values in
    order adds the same numbers in the same order as it would unsplit."""
    meshes = [l.device_mesh for l in likes if isinstance(l, DTensor)]
    if not meshes:
        return list(values)
    mesh = meshes[0]
    vals = [v.to(torch.float32).reshape(()) for v in values]
    splits = [sharded_dims(l) for l in likes]
    for i, name in enumerate(mesh.mesh_dim_names):
        first = mesh.get_local_rank(i) == 0
        # built on the host's knowledge alone: no copy to the device
        vec = torch.stack([v if first or name in split else torch.zeros_like(v)
                           for v, split in zip(vals, splits)])
        dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=mesh.get_group(name))
        vals = list(vec.unbind(0))
    return vals


class BatchSplit:
    """A batch-major tensor's local rows: ``local`` holds them, replicated
    over every mesh dim but the batch split over the data axes; ``wrap`` makes a DTensor split
    the same way from local rows, ``mean`` averages a per-shard mean over
    the shards, and ``partial`` are the gradient placements of a
    replicated weight used on these rows only. For a plain tensor ``wrap``
    and ``mean`` are identities. ``split=False`` gathers every row."""

    def __init__(self, t, split: bool = True) -> None:
        self.mesh = t.device_mesh if isinstance(t, DTensor) else None
        if self.mesh is None:
            self.local, self.placements, self.partial, self.n = t, None, None, 1
            return
        self.placements = tuple(
            Shard(0) if split and p == Shard(0) and n in ("pod", "data")
            else Replicate()
            for n, p in zip(self.mesh.mesh_dim_names, t.placements))
        self.n = 1
        for i, p in enumerate(self.placements):
            if p == Shard(0):
                self.n *= self.mesh.size(i)
        self.local = t.redistribute(self.mesh, self.placements).to_local()
        # the gradient of a replicated weight applied to these rows only
        self.partial = tuple(Partial() if p == Shard(0) else Replicate()
                             for p in self.placements)

    def wrap(self, x: torch.Tensor):
        if self.mesh is None:
            return x
        shape = torch.Size((x.shape[0] * self.n,) + tuple(x.shape[1:]))
        return DTensor.from_local(x, self.mesh, self.placements,
                                  run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.n == 1:
            return x
        summed = tuple(Partial() if p == Shard(0) else Replicate()
                       for p in self.placements)
        return DTensor.from_local(x / self.n, self.mesh, summed,
                                  run_check=False).full_tensor()


def reduce_pending(t):
    """``t`` with a pending sum (a ``Partial`` placement: the output of a
    product over a split dim, a row-parallel layer's) reduced at once, as
    Megatron's row-parallel layer all-reduces its output. Left pending,
    DTensor (torch 2.13) carries the sum through the residual adds and
    norms: it then all-reduces the input of every later product and runs
    their weight gradients at full width on every process."""
    if not isinstance(t, DTensor) or not any(
            p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in t.placements))


class _ReduceGrad(torch.autograd.Function):
    """Identity whose backward reduces a pending sum of the gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduce_pending(grad)


def reduce_grad(t):
    """``t``, whose gradient is reduced at once where it comes back a
    pending sum (the input of a product with a split weight: Megatron's
    column-parallel backward all-reduce), for the reason
    ``reduce_pending`` gives."""
    if not isinstance(t, DTensor) or not t.requires_grad:
        return t
    return _ReduceGrad.apply(t)


def whole_dim0(t):
    """``t`` with any split of its dim 0 gathered: a stacked leaf whose
    layer dim FSDP split over the data axes (mode ``auto``) is unbound
    into its layers, which DTensor cannot do along a split dim. The
    gradient comes back split as ``t`` (the gather's backward)."""
    if not isinstance(t, DTensor) or Shard(0) not in t.placements:
        return t
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if p == Shard(0) else p for p in t.placements))


def split_batch(t):
    """A batch-major DTensor split on dim 0 over the mesh's data axes, its
    other placements kept (from a replicated batch, a local cut)."""
    mesh = t.device_mesh
    pl = tuple(Shard(0) if n in ("pod", "data") else p
               for n, p in zip(mesh.mesh_dim_names, t.placements))
    return t if pl == tuple(t.placements) else t.redistribute(mesh, pl)


def rows_submesh(rows: BatchSplit):
    """The ``model`` sub-mesh of a batch split's mesh where that mesh has
    other axes too (mode ``auto``: FSDP over the data axes and TP), else
    None."""
    mesh = rows.mesh
    if mesh is None or "model" not in mesh.mesh_dim_names or mesh.ndim == 1:
        return None
    return mesh["model"]


def to_submesh(w, rows: BatchSplit, sub):
    """``w``, a DTensor on ``rows``' mesh, as a DTensor on its ``model``
    sub-mesh ``sub``: its split over the other axes (FSDP) gathered, its
    ``model`` placement kept. Used on ``rows`` alone, its gradient is a
    partial sum over their split."""
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    keep = tuple(p if n == "model" else Replicate()
                 for n, p in zip(names, w.placements))
    grad = tuple(p if n == "model" else rp
                 for n, p, rp in zip(names, w.placements, rows.partial))
    loc = w.redistribute(mesh, keep).to_local(grad_placements=grad)
    return DTensor.from_local(loc, sub, (keep[names.index("model")],),
                              run_check=False, shape=w.shape,
                              stride=contiguous_stride(w.shape))


def gather_unless_divides(t, dim: int, groups: int):
    """``t`` with its split of ``dim`` gathered where the split does not
    divide ``groups``, the number of whole groups (heads) ``dim`` is about
    to be reshaped into: a shard boundary inside a group cannot be viewed
    (GQA with fewer KV heads than the model axis)."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.ndim
    mesh = t.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim % t.ndim == dim
          and groups % mesh.size(i) else p for i, p in enumerate(t.placements)]
    return t if pl == list(t.placements) else t.redistribute(mesh, pl)


def local_map(fn, acts, weights=(), split_dim: int | None = None):
    """``fn(*acts, *weights)`` on local tensors, its output (a tensor or a
    tuple of them) made DTensors again: the recurrent layers' loops and
    chunked recurrences run this way, so that no op inside goes through
    DTensor's dispatch (some, such as ``log_sigmoid_backward``, have no
    sharding rule at all).

    ``acts`` are batch-major activations. Two of their splits are kept: a
    batch split (dim 0 over the data axes) that every act shares, and, with
    ``split_dim``, a split of that dim over ``model`` (independent heads or
    channels): an act held whole there is cut to the split, for free.
    Every other split is gathered first. ``weights`` are gathered whole;
    their gradient from these rows is a partial sum over each kept split.
    The outputs are placed as the acts were kept, dim 0 and ``split_dim``
    scaled to their global sizes. Without a DTensor argument ``fn`` runs
    as it is."""
    if not any(isinstance(t, DTensor) for t in (*acts, *weights)):
        return fn(*acts, *weights)
    mesh = next(t for t in (*acts, *weights)
                if isinstance(t, DTensor)).device_mesh
    names = mesh.mesh_dim_names
    whole = (Replicate(),) * len(names)

    def kept(t, i, n):
        p = t.placements[i] if isinstance(t, DTensor) else Replicate()
        if n in ("pod", "data"):
            return p if p == Shard(0) else Replicate()
        if n == "model" and split_dim is not None and p == Shard(split_dim):
            return p
        return Replicate()

    pl = []
    for i, n in enumerate(names):
        got = {kept(t, i, n) for t in acts}
        if n == "model":
            # a split shared by the split acts, the whole ones cut to it
            got.discard(Replicate())
        pl.append(got.pop() if len(got) == 1 else Replicate())
    pl = tuple(pl)
    partial = tuple(Partial() if isinstance(p, Shard) else Replicate()
                    for p in pl)

    def place(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, whole, run_check=False)
        return _ContiguousGrad.apply(t.redistribute(mesh, pl).to_local())

    loc = [place(t) for t in acts]
    loc += [(t.redistribute(mesh, whole).to_local(grad_placements=partial)
             if isinstance(t, DTensor) else t) for t in weights]
    out = fn(*loc)

    def wrap(o):
        shape = list(o.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                shape[p.dim % o.ndim] *= mesh.size(i)
        shape = torch.Size(shape)
        return DTensor.from_local(o, mesh, pl, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def split_rows_for(y, w):
    """``y`` cut on its last dim as ``w`` is split on its rows over
    ``model``, so that ``y @ w`` runs row-parallel on local shards (a cut
    of a whole ``y`` moves nothing); ``y`` as it is otherwise."""
    if not (isinstance(y, DTensor) and shard_dim(w) == 0):
        return y
    names = y.device_mesh.mesh_dim_names
    pl = tuple(Shard(y.ndim - 1) if n == "model" else p
               for n, p in zip(names, y.placements))
    return y.redistribute(y.device_mesh, pl)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    DTensor view in the backward (of the head split before it) cannot view
    the strided gradients of the local attention."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local_heads(q, k, v, kv_heads: int, split_heads: bool = True):
    """Attention's operands (B, T, heads, Dh) as local tensors, with
    ``wrap(o, shape)``, which makes a DTensor of global ``shape`` from a
    local output whose dim 0 holds the local batch rows and dim 2 the
    local heads (merged with Dh or not). Attention is independent per batch
    row and head, so a split of the batch over the data axes and of the
    heads over ``model`` is kept where all three operands share it and it
    divides the KV heads (a shard never cuts a GQA group); every other
    split is gathered first, and the heads too without ``split_heads``."""
    mesh = q.device_mesh

    def keep(t):
        return tuple(
            p if (p == Shard(0) and n in ("pod", "data"))
            or (p == Shard(2) and n == "model" and split_heads
                and kv_heads % mesh.size(i) == 0)
            else Replicate()
            for i, (n, p) in enumerate(zip(mesh.mesh_dim_names, t.placements)))

    kept = [keep(t) for t in (q, k, v)]
    pl = tuple(p if all(kp[i] == p for kp in kept) else Replicate()
               for i, p in enumerate(kept[0]))
    locals_ = [_ContiguousGrad.apply(t.redistribute(mesh, pl).to_local())
               for t in (q, k, v)]

    def wrap(o: torch.Tensor, shape):
        shape = torch.Size(shape)
        return DTensor.from_local(o, mesh, pl, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))

    return (*locals_, wrap)
