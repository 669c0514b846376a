"""AdamW + cosine LR schedule with linear warmup (port of ``repro/optim/adam.py``).

Functional: ``update`` returns new parameter and moment trees;
``update(..., inplace=True)`` writes the same values into the given
parameter and moment tensors instead, a slice of at most
``INPLACE_CHUNK`` elements at a time, so an update holds no second copy
of the state (the flat trainer donates its state to the step, as the
reference's ``jit`` does). Weight decay applies to leaves with ndim >= 2,
as in the reference (which makes it reach the stacked (L, d) norm scales
too). Moments are fp32 unless ``opt_dtype`` says otherwise.

Tensor parallelism: DTensor leaves update on their local shards (the
in-place path writes into the shards' storage) and come back placed as
given; ``sum_squares`` sums each leaf's local squares over the mesh dims
it is split on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.dist import tp

F32 = torch.float32
INPLACE_CHUNK = 1 << 26        # elements per slice of an in-place update


class AdamState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    m: Any                   # tree like params
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    opt_dtype: str = "float32"


def lr_at(cfg: AdamConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * lr (fp32, on step's device)."""
    step = torch.as_tensor(step).to(F32)
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1.0 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params, cfg: AdamConfig) -> AdamState:
    dt = getattr(torch, cfg.opt_dtype)
    zeros = lambda p: tp.rewrap(p, torch.zeros(
        tp.local(p).shape, dtype=dt, device=p.device))
    device = tree.leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=tree.tree_map(zeros, params),
                     v=tree.tree_map(zeros, params))


def sum_squares(tree_) -> torch.Tensor:
    """The fp32 sum of squares over a tree's leaves; a DTensor leaf's
    local squares are summed over its split once (``tp.leafwise_sums``)."""
    leaves = tree.leaves(tree_)
    sq = [torch.sum(tp.local(l).to(F32) ** 2) for l in leaves]
    if any(isinstance(l, DTensor) for l in leaves):
        sq = tp.leafwise_sums(sq, leaves)
    return sum(sq)


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum_squares(grads))


@torch.no_grad()
def update(params, grads, state: AdamState, cfg: AdamConfig, gnorm=None,
           inplace: bool = False):
    """One AdamW step. Returns (new_params, new_state, metrics).

    The step count, LR and bias corrections are computed on the device from
    ``state.step``, so an update needs no host sync. ``inplace`` writes
    the new values into ``params``, ``state.m`` and ``state.v`` (returned
    as the new trees), elementwise the same arithmetic.
    """
    b1, b2 = cfg.betas
    step = state.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    lr = lr_at(cfg, step)
    c1 = 1.0 - b1 ** step.to(F32)
    c2 = 1.0 - b2 ** step.to(F32)
    dt = getattr(torch, cfg.opt_dtype)

    def leaf(p, g, m, v, decay):
        g32 = g.to(F32) * scale
        m32 = b1 * m.to(F32) + (1 - b1) * g32
        v32 = b2 * v.to(F32) + (1 - b2) * g32 * g32
        upd = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if decay:
            upd = upd + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * upd).to(p.dtype), m32.to(dt), v32.to(dt)

    def leaf_inplace(p, g, m, v, decay):
        # the state is written through views (raises unless contiguous);
        # the gradient is only read (a split gradient may be strided)
        flat = [t.view(-1) if t is not g else t.reshape(-1)
                for t in (p, g, m, v)]
        for lo in range(0, p.numel(), INPLACE_CHUNK):
            part = [t[lo:lo + INPLACE_CHUNK] for t in flat]
            for dst, new in zip((part[0], part[2], part[3]),
                                leaf(*part, decay)):
                dst.copy_(new)
        return p, m, v

    one = leaf_inplace if inplace else leaf

    def placed(p, g, m, v):
        new = one(*(tp.local(t) for t in (p, g, m, v)),
                  cfg.weight_decay > 0 and p.ndim >= 2)
        return tuple(tp.rewrap(like, t) for like, t in zip((p, m, v), new))

    out = [placed(p, g, m, v) for p, g, m, v in zip(
        tree.leaves(params), tree.leaves(grads), tree.leaves(state.m),
        tree.leaves(state.v))]
    new_p = tree.unflatten(params, [o[0] for o in out])
    new_m = tree.unflatten(params, [o[1] for o in out])
    new_v = tree.unflatten(params, [o[2] for o in out])
    return new_p, AdamState(step=step, m=new_m, v=new_v), {
        "lr": lr, "grad_norm": gnorm}
