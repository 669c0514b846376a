"""Process meshes over ``torch.distributed``.

Port of ``make_host_mesh`` from ``repro/launch/mesh.py``. Each process is
one device of the mesh; the caller initialises the default process group
with a world of the product of the axis sizes. The outer axis is the slow
one, so rank = s * data + w on a ``(pipe, data)`` mesh, rank = w * model +
t on a ``(data, model)`` mesh and rank = (s * data + w) * model + t on a
``(pipe, data, model)`` mesh: each pipeline stage owns a contiguous block
of data-parallel workers, and each DP worker a contiguous tensor-parallel
group, as the reference lays them out:

  mesh = make_host_mesh(pipe=2, data=2, device_type="cpu")   # gloo
  mesh.get_group("pipe")   # this process's column: its stage peers
  mesh.get_group("data")   # this process's row: its stage's DP workers
  mesh = make_host_mesh(data=2, model=2, device_type="cpu")
  mesh["model"]            # the sub-mesh the dp_tp parameters live on
  mesh = make_host_mesh(pipe=2, data=1, model=2, device_type="cpu")

``model`` > 0 builds a mesh with a ``model`` axis, at model size 1 too.
``pod`` > 0 puts a ``pod`` axis outermost, at pod size 1 too, as the
reference does: ``(pod, data)``, ``(pod, data, model)``, ``(pod, pipe,
data)`` and ``(pod, pipe, data, model)``, with rank = ((p * pipe + s) *
data + w) * model + t (an absent axis has size 1). Each pod is a
data-parallel island: the DP mean runs over pod and data together
(``dp_group``), pod-major, so a pipeline stage's DP workers are its
(pod, data) peers and worker p * data + w takes the p * data + w-th slice
of the global batch, as the reference's ``pmean`` over ("pod", "data")
does:

  mesh = make_host_mesh(pod=2, data=2, device_type="cpu")
  dp_group(mesh)           # the four processes, pod-major
  mesh = make_host_mesh(pod=2, pipe=2, data=1, device_type="cpu")
  dp_group(mesh)           # this stage's two processes, one a pod

The elastic outer loop runs its pods in one process on
``make_pod_mesh``'s carrier, as the reference runs them on its
1-device-per-pod mesh; a training mesh's ``pod`` axis is another thing:
pods that step together, every step synced across them.

``make_production_mesh`` builds the reference's production shapes, 256
ranks a pod: ``(16, 16)`` over ("data", "model"), ``(2, 16, 16)`` over
("pod", "data", "model"), and with ``pipe`` stages the pipe axis split
off the data axis (pod outermost, then pipe, data, model). It is built
over whatever default group the caller made: the dry run
(``launch/dryrun.py``) makes a fake one of 256 or 512 ranks.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.dist.collectives import PodCarrier

__all__ = ["dp_axes", "dp_group", "dp_index", "dp_size", "make_host_mesh",
           "make_pod_mesh", "make_production_mesh", "pipe_size",
           "production_sizes", "tp_axis"]


def production_sizes(*, multi_pod: bool = False, pipe: int = 0
                     ) -> dict[str, int]:
    """``{axis: size}`` of the production mesh, outer axis first."""
    sizes = {"pod": 2} if multi_pod else {}
    if pipe and pipe > 1:
        data = (16 * 16) // (pipe * 16)
        if data < 1 or (pipe * data * 16) != 256:
            raise ValueError(f"pipe={pipe} does not divide the 256-chip pod")
        sizes["pipe"] = pipe
    else:
        data = 16
    return dict(sizes, data=data, model=16)


def make_production_mesh(*, multi_pod: bool = False, pipe: int = 0,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production mesh (``repro/launch/mesh.py:33-44``)
    over the default group's 256 (512 with ``multi_pod``) ranks."""
    sizes = production_sizes(multi_pod=multi_pod, pipe=pipe)
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def make_host_mesh(data: int = 1, model: int = 0, pod: int = 0,
                   pipe: int = 0, device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the default process group's ranks: the axes ``pod``,
    ``pipe``, ``data`` and ``model`` in that order, ``data`` always and
    each other one where its size is > 0; ``device_type`` is "cuda" (NCCL,
    one card per process) or "cpu" (gloo)."""
    sizes = {"pod": pod, "pipe": pipe, "data": data, "model": model}
    sizes = {k: v for k, v in sizes.items() if k == "data" or v}
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh, pod-major."""
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_group(mesh):
    """The process group of a mesh's data-parallel axes (``dp_axes``):
    ``data``'s, or with a ``pod`` axis pod and data flattened into one
    group, pod-major, over which the DP mean runs as the reference's
    ``pmean`` over ("pod", "data") does; None without a mesh. Where
    ``pipe`` sits between ``pod`` and ``data`` the flattened group is this
    stage's; every process must call it, as it makes the groups."""
    axes = dp_axes(mesh)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    group = mesh[axes]._flatten().get_group()
    if dist.get_process_group_ranks(group) != _dp_ranks(mesh):
        raise RuntimeError(
            f"flattened {axes} group {dist.get_process_group_ranks(group)} "
            f"is not this process's pod-major DP peers {_dp_ranks(mesh)}")
    return group


def _dp_ranks(mesh) -> list[int]:
    """The global ranks of this process's data-parallel peers, pod-major."""
    grid, axes = mesh.mesh, dp_axes(mesh)
    for i, name in reversed(list(enumerate(mesh.mesh_dim_names))):
        if name not in axes:
            grid = grid.select(i, mesh.get_local_rank(i))
    return grid.flatten().tolist()


def dp_index(mesh) -> int:
    """This process's data-parallel worker on a mesh, pod-major: p * data +
    w (0 without a mesh)."""
    if mesh is None:
        return 0
    index = 0
    for name in dp_axes(mesh):
        i = mesh.mesh_dim_names.index(name)
        index = index * mesh.size(i) + mesh.get_local_rank(i)
    return index


def dp_size(mesh) -> int:
    """The data-parallel world of a mesh: pod x data (1 without a mesh)."""
    n = 1
    for name in dp_axes(mesh):
        n *= mesh.size(mesh.mesh_dim_names.index(name))
    return n


def tp_axis(mesh) -> str | None:
    """The tensor-parallel axis of a mesh (None without one)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    return "model"


def make_pod_mesh(n_pods: int, devices) -> PodCarrier:
    """The ``pod`` axis of the outer loop: ``n_pods`` pods on ``devices``
    (the reference's ``make_pod_mesh``, ``repro/launch/mesh.py:67-75``)."""
    return PodCarrier(n_pods, devices)


def pipe_size(mesh: DeviceMesh | None) -> int:
    """Size of the mesh's ``pipe`` axis (1 without one)."""
    if mesh is None or "pipe" not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("pipe"))
