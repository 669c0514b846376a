"""Process meshes over ``torch.distributed``.

Port of ``make_host_mesh`` from ``repro/launch/mesh.py``. Each process is
one device of the mesh; the caller initialises the default process group
with a world of ``pipe * data``, ``data * model`` or ``pipe * data *
model`` processes. The outer axis is the slow one, so rank = s * data + w
on a ``(pipe, data)`` mesh, rank = w * model + t on a ``(data, model)``
mesh and rank = (s * data + w) * model + t on a ``(pipe, data, model)``
mesh: each pipeline stage owns a contiguous block of data-parallel
workers, and each DP worker a contiguous tensor-parallel group, as the
reference lays them out:

  mesh = make_host_mesh(pipe=2, data=2, device_type="cpu")   # gloo
  mesh.get_group("pipe")   # this process's column: its stage peers
  mesh.get_group("data")   # this process's row: its stage's DP workers
  mesh = make_host_mesh(data=2, model=2, device_type="cpu")
  mesh["model"]            # the sub-mesh the dp_tp parameters live on
  mesh = make_host_mesh(pipe=2, data=1, model=2, device_type="cpu")

``model`` > 0 builds a mesh with a ``model`` axis, at model size 1 too.
Pods as processes across cards are ROADMAP item 10b: a ``pod`` axis
above 1 raises, beside ``model`` too. The elastic outer
loop runs its pods in one process on ``make_pod_mesh``'s carrier, as the
reference runs them on its 1-device-per-pod mesh.

``make_production_mesh`` builds the reference's production shapes, 256
ranks a pod: ``(16, 16)`` over ("data", "model"), ``(2, 16, 16)`` over
("pod", "data", "model"), and with ``pipe`` stages the pipe axis split
off the data axis (pod outermost, then pipe, data, model). It is built
over whatever default group the caller made: the dry run
(``launch/dryrun.py``) makes a fake one of 256 or 512 ranks. On such a
mesh the data-parallel mean runs over ("pod", "data") together
(``dp_group``).
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.dist.collectives import PodCarrier

__all__ = ["dp_axes", "dp_group", "make_host_mesh", "make_pod_mesh",
           "make_production_mesh", "pipe_size", "production_sizes",
           "tp_axis"]


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
    """A mesh over the default process group's ranks: ``("pipe", "data",
    "model")`` with ``pipe`` and ``model`` > 0, ``("data", "model")`` with
    ``model`` alone, ``("pipe", "data")`` with ``pipe`` alone, else
    ``("data",)``; ``device_type`` is "cuda" (NCCL, one card per process)
    or "cpu" (gloo)."""
    if pod > 1:
        raise ValueError(f"pod={pod}, model={model}: pods as processes "
                         "across cards are ROADMAP Queue 1 item 10b")
    if pipe and model:
        return init_device_mesh(device_type, (pipe, data, model),
                                mesh_dim_names=("pipe", "data", "model"))
    if pipe:
        return init_device_mesh(device_type, (pipe, data),
                                mesh_dim_names=("pipe", "data"))
    if model:
        return init_device_mesh(device_type, (data, model),
                                mesh_dim_names=("data", "model"))
    return init_device_mesh(device_type, (data,), mesh_dim_names=("data",))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh, pod-major."""
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_group(mesh):
    """The process group of a mesh's data-parallel axes (``dp_axes``):
    ``data``'s, or with a ``pod`` axis pod and data flattened into one
    group, pod-major, over which the DP mean runs as the reference's
    ``pmean`` over ("pod", "data") does; None without a mesh."""
    axes = dp_axes(mesh)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


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
