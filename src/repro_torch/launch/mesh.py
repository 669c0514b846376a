"""Process meshes over ``torch.distributed``.

Port of ``make_host_mesh`` from ``repro/launch/mesh.py``. Each process is
one device of the mesh; the caller initialises the default process group
with a world of ``pipe * data`` processes. The pipe axis is the outer one,
so rank = s * data + w and each pipeline stage s owns a contiguous
data-parallel group, as the reference lays it out:

  mesh = make_host_mesh(pipe=2, data=2, device_type="cpu")   # gloo
  mesh.get_group("pipe")   # this process's column: its stage peers
  mesh.get_group("data")   # this process's row: its stage's DP workers

The ``model`` and ``pod`` axes of a process mesh (tensor parallelism, and
pods as processes across cards) are ROADMAP Queue 1 items 12 and 10b: a
size above 1 raises. The elastic outer loop runs its pods in one process
on ``make_pod_mesh``'s carrier, as the reference runs them on its
1-device-per-pod mesh.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.dist.collectives import PodCarrier

__all__ = ["make_host_mesh", "make_pod_mesh", "pipe_size"]


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   pipe: int = 0, device_type: str = "cuda") -> DeviceMesh:
    """A ``("pipe", "data")`` mesh (``("data",)`` with ``pipe=0``) over the
    default process group's ranks; ``device_type`` is "cuda" (NCCL, one
    card per process) or "cpu" (gloo)."""
    if model > 1 or pod > 1:
        raise ValueError(f"model={model}, pod={pod}: the model and pod mesh "
                         "axes are not ported yet (ROADMAP Queue 1 item 12)")
    if pipe:
        return init_device_mesh(device_type, (pipe, data),
                                mesh_dim_names=("pipe", "data"))
    return init_device_mesh(device_type, (data,), mesh_dim_names=("data",))


def make_pod_mesh(n_pods: int, devices) -> PodCarrier:
    """The ``pod`` axis of the outer loop: ``n_pods`` pods on ``devices``
    (the reference's ``make_pod_mesh``, ``repro/launch/mesh.py:67-75``)."""
    return PodCarrier(n_pods, devices)


def pipe_size(mesh: DeviceMesh | None) -> int:
    """Size of the mesh's ``pipe`` axis (1 without one)."""
    if mesh is None or "pipe" not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("pipe"))
