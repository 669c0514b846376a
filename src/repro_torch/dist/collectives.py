"""Data-parallel gradient-sync collectives on ``torch.distributed``.

Port of ``make_dp_pmean`` and ``make_dp_psum`` from
``repro/dist/collectives.py``. Each process is one data-parallel worker;
the sum over workers is an all-reduce (SUM), the mean that sum divided by
the world size. Without an initialised process group (or at
world size 1) it is the identity, the reference's single-worker case.

Every function takes an optional process ``group``: the data group of a
``(pipe, data)`` or ``(data, model)`` mesh (``launch/mesh.py``), where each
pipeline stage or tensor-parallel rank owns a DP group of its own. Without
one they act on the default group.

The model group of a ``(data, model)`` mesh has its own two collectives:
``make_model_psum`` sums a tensor over it and ``model_all_gather``
concatenates its shards along a dim. They are what GSPMD inserts on the
reference's AUTO ``model`` axis, made explicit for the compressed sync of
tensor-parallel leaves; they run at model size 1 too, so the card, which
has one device, drives them.

``PodCarrier`` is the outer loop's pod axis in one process (the port of
the reference's 1-device-per-pod ``pod`` mesh, which runs every pod in one
process too): a tensor stacked over the pods (leading dim N, or N x L for
a stacked leaf folded to one batch dim) is averaged over that dim.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import tree

__all__ = ["dp_world_size", "dp_rank", "make_dp_pmean", "make_dp_psum",
           "dp_all_gather", "dp_barrier", "make_model_psum",
           "model_all_gather", "PodCarrier"]


def dp_world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def dp_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def _summed_copy(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``t`` summed over ``group`` (the all-reduce
    sums storage in memory order; the input is never written)."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def make_dp_pmean(group=None) -> Callable[[Any], Any]:
    """Mean over the data-parallel workers of a tensor or a tree of them.

    The input is never written: each collective reduces a contiguous
    copy (the all-reduce sums storage in memory order).
    """
    world = dp_world_size(group)
    if world == 1:
        return lambda x: x
    return lambda x: tree.tree_map(
        lambda t: _summed_copy(t, group).div_(world), x)


def make_dp_psum(group=None) -> Callable[[Any], Any]:
    """Sum over the data-parallel workers of a tensor or a tree of them
    (the identity at world size 1). The input is never written."""
    if dp_world_size(group) == 1:
        return lambda x: x
    return lambda x: tree.tree_map(lambda t: _summed_copy(t, group), x)


def dp_all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every worker's ``t`` stacked on a new leading dim, in rank order."""
    world = dp_world_size(group)
    if world == 1:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def make_model_psum(group) -> Callable[[torch.Tensor], torch.Tensor]:
    """Sum over the model group (a contiguous copy is reduced; the input
    is never written)."""
    return lambda t: _summed_copy(t, group)


def model_all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The model group's shards of a tensor concatenated along ``dim``, in
    rank order."""
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def dp_barrier(group=None) -> None:
    """Wait for every data-parallel worker (nothing to wait for alone)."""
    if dp_world_size(group) > 1:
        dist.barrier(group=group)


class PodCarrier:
    """The pods of the elastic outer loop, all in this process.

    ``devices`` are the devices the pods may live on (one card repeated
    when they share it); their number caps ``pod_join``. The first
    ``n_pods`` host the live pods; the outer state lives on the first.
    """

    def __init__(self, n_pods: int, devices) -> None:
        devices = [torch.device(d) for d in devices]
        if not 1 <= n_pods <= len(devices):
            raise ValueError(f"{n_pods} pods need {n_pods} devices, have "
                             f"{len(devices)}")
        self.n_pods = n_pods
        self.devices = devices

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the pods of a pod-stacked tensor, given back to every
        pod: ``x``'s leading dim is N, or N x L, each pod's slice a
        contiguous run of it."""
        n = self.n_pods
        if x.shape[0] % n:
            raise ValueError(f"leading dim {x.shape[0]} is not a multiple of "
                             f"{n} pods")
        rows = x.reshape((n, -1))
        mean = rows.sum(dim=0) / n
        return mean.expand(rows.shape).reshape(x.shape).contiguous()
