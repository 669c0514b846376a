"""Carry the reference trainer's state across into the port.

``from_reference(state_np, device)`` takes the flat reference trainer's
state as numpy arrays (``jax.device_get(trainer.state)``: ``params``,
``opt_m``, ``opt_v``, ``opt_step`` and the stacked or per-leaf compressor
state ``comp``) and returns the port's state dict with the same trees; the
entries given are converted, so ``{"params": ...}`` alone carries weights.
The reference gives every compressor leaf a leading per-worker replica
dim; the port keeps one worker's state per process, so replica 0 is taken.
Compressor entries are ``LowRankState`` pairs (q, err), or, under a coded
wire, raw ``ef:<path>`` residuals, which come across as fp32 tensors.

``from_reference(..., mesh=)`` places the state on a ``(data, model)``
mesh as the port's trainer holds it (``train.step.distribute_state``): on
the ``model`` sub-mesh, or with ``fsdp=True`` (the ``auto`` step) on the
whole mesh; each process takes its own DP worker's compressor replica,
worker p * data + w on a mesh with a ``pod`` axis (pod-major, as the
reference's ``(W, ...)`` and ``(S, W, ...)`` layouts count it).

The pipelined reference trainer's state (``stage_params`` with leaves
(S, Lmax, ...), ``shared_params``, ``opt_m``/``opt_v`` as ``{"stage",
"shared"}``, ``opt_step`` and ``comp`` with leaves (S, W, ...)) converts
the same way; its compressor leaves keep the stage dim and take worker
0's slice. Only numpy is read here: nothing of JAX is imported.

``outer_from_reference(arrays_np, device)`` takes the reference
``OuterOptimizer``'s ``arrays`` (``outer_m``, the momentum tree, and
``outer_comp``, per-leaf (q, err) pairs) and returns them for the port's
``OuterOptimizer.load_arrays``. The outer state keeps every pod's rows in
both packages, so the leading pod dim comes across whole.

``cache_from_reference(cache_np, device)`` takes a reference decode cache
(``jax.device_get(model.init_cache(...))`` or one a ``decode_step``
returned) and returns the port's: the same tree, the same shapes and
dtypes, with ``len`` a 0-d int32 tensor.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.powersgd import LowRankState
from repro_torch.launch.mesh import dp_index

__all__ = ["from_reference", "outer_from_reference", "cache_from_reference",
           "to_tensor"]


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> torch tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_reference(state_np: dict[str, Any], device="cpu", mesh=None,
                   fsdp: bool = False) -> dict[str, Any]:
    conv = lambda t: tree.tree_map(lambda a: to_tensor(a, device), t)
    w = dp_index(mesh)
    out: dict[str, Any] = {}
    for key in ("params", "opt_m", "opt_v", "stage_params", "shared_params"):
        if key in state_np:
            out[key] = conv(state_np[key])
    if "opt_step" in state_np:
        out["opt_step"] = to_tensor(np.asarray(state_np["opt_step"], np.int32),
                                    device)
    if "comp" in state_np:
        # flat: (W, ...) leaves; pipelined: (S, W, ...), worker after stage
        worker = ((lambda a: np.asarray(a)[:, w])
                  if "stage_params" in state_np
                  else (lambda a: np.asarray(a)[w]))
        out["comp"] = {key: _comp_entry(st, worker, device)
                       for key, st in state_np["comp"].items()}
    if mesh is not None:
        from repro_torch.train.step import distribute_state
        out = distribute_state(out, mesh if fsdp else mesh["model"],
                               fsdp=fsdp)
    return out


def _comp_entry(st, worker, device):
    if isinstance(st, tuple):
        q, err = st
        return LowRankState(q=to_tensor(worker(q), device),
                            err=to_tensor(worker(err), device))
    return to_tensor(np.asarray(worker(st), np.float32), device)


def outer_from_reference(arrays_np: dict[str, Any], device="cpu"
                         ) -> dict[str, Any]:
    keep = lambda a: a
    return {"outer_m": tree.tree_map(lambda a: to_tensor(a, device),
                                     arrays_np["outer_m"]),
            "outer_comp": {key: _comp_entry(st, keep, device)
                           for key, st in arrays_np["outer_comp"].items()}}


def cache_from_reference(cache_np: dict[str, Any], device="cpu"
                         ) -> dict[str, Any]:
    return tree.tree_map(lambda a: to_tensor(a, device), cache_np)
