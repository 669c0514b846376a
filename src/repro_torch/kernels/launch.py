"""What every kernel wrapper of the port shares: the device rule and the launch.

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel on a Hopper card or raises. ``launch`` calls one C
entry point of a library built by ``build.py`` on the tensors' device and
its current stream, raises on a refused launch, and counts the launch on
the wrapper (``<wrapper>.launches``).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["on_cpu", "ptr", "launch"]


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU inputs (plain version); CUDA inputs must be on sm_90."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"{torch.cuda.get_device_name(dev)} is not sm_90: "
                           "the kernels are built for Hopper (sm_90a)")
    return False


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(lib: ctypes.CDLL, wrapper, name: str, device: torch.device,
           *args) -> None:
    """Launch C entry point ``name`` of ``lib`` on ``device``'s current stream.

    ``device`` is made current for the launch, so tensors on another card
    than the current one run there. Raises on a refused launch; counts
    the launch on ``wrapper`` otherwise.
    """
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    wrapper.launches += 1
