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
Only numpy is read here: nothing of JAX is imported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.powersgd import LowRankState

__all__ = ["from_reference", "to_tensor"]


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> torch tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_reference(state_np: dict[str, Any], device="cpu") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key in ("params", "opt_m", "opt_v"):
        if key in state_np:
            out[key] = tree.tree_map(lambda a: to_tensor(a, device),
                                     state_np[key])
    if "opt_step" in state_np:
        out["opt_step"] = to_tensor(np.asarray(state_np["opt_step"], np.int32),
                                    device)
    if "comp" in state_np:
        out["comp"] = {key: _comp_entry(st, device)
                       for key, st in state_np["comp"].items()}
    return out


def _comp_entry(st, device):
    if isinstance(st, tuple):
        q, err = st
        return LowRankState(q=to_tensor(np.asarray(q)[0], device),
                            err=to_tensor(np.asarray(err)[0], device))
    return to_tensor(np.asarray(st, np.float32)[0], device)
