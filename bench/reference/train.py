"""Three training steps of the plain reference: loss and gradients, the DP
sync with PowerSGD and error feedback, the GDS entropy, and AdamW.

What the port derives from the seed is worked out again here, by the rules
the port documents:

* which matrices are compressed, and at what rank (``bench.flops``);
* the warm-start Q of the i-th compressed leaf in the tree's flatten order:
  standard-normal fp32 draws of shape (..., n, r) from a CPU
  ``torch.Generator`` seeded with ``fold_in(fold_in(seed, 99), i)``;
* the EF residual, zero at the start and one per replica.

Each replica takes its contiguous rows of the global batch; its gradient
is the mean over its rows, summed here over blocks of rows so that the
fp32 activations fit. Per compressed matrix: M_r = G_r + E_r, P = mean_r
M_r Q, P^ = orth(P), Q' = mean_r M_r^T P^, g^ = P^ Q'^T, E_r' = M_r - g^,
and Q' is the next warm start; every other leaf is the mean over replicas.
``orth`` is the mix's ``orthonormalisation``: Gram-Schmidt, each column
divided by its norm plus ``eps`` (PowerSGD's, and the route of the card's
kernels, which leaves a column that P does not span near zero), or
Householder QR (the port's plain path on the CPU).
Then the Gaussian entropy of the pooled strided sample (on a gated step),
the clip by the global norm, and AdamW with weight decay on every leaf of
two or more dims (the stacked norm scales and biases included). The
updated weights are stored in the configuration's dtype (rounded to
nearest), as the weights of a bf16 model are: an update below half a
unit in the last place, as lr 1e-3 is to a norm scale of 1, leaves the
weight as it was.
"""
from __future__ import annotations

import math

import torch

from bench import flops, weights
from bench.reference import model as ref_model

F32 = torch.float32


def fold_in(seed: int, i: int) -> int:
    """The port's seed derivation: a 63-bit seed from (seed, i)."""
    x = (seed * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) % (1 << 64)
    x ^= x >> 31
    return (x * 0x94D049BB133111EB % (1 << 64)) >> 1


def warm_q(m: dict, mix: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The warm-start Q of every compressed unit, (n, r) fp32 (none under
    the ``none`` policy)."""
    if mix["policy"] == "none":
        return {}
    if mix["policy"] != "fixed":
        raise ValueError(f"the reference follows the fixed and none policies, "
                         f"not {mix['policy']!r}")
    rank, comp_seed = mix["rank"], fold_in(seed, 99)
    out, i = {}, 0
    offs = [sum(weights.stage_sizes(m)[:s]) for s in range(len(weights.stage_sizes(m)))]
    for leaf in weights.leaves(m):
        if not flops.compressed(leaf):
            continue
        r = flops.leaf_rank(leaf, rank)
        gen = torch.Generator().manual_seed(fold_in(comp_seed, i))
        i += 1
        q = torch.randn(tuple(leaf.shape[:-2]) + (leaf.shape[-1], r),
                        generator=gen, dtype=F32).to(device)
        for j in range(leaf.shape[0]):
            name = f"L{offs[leaf.path[1]] + j}." + ".".join(str(k) for k in leaf.path[3:])
            out[name] = q[j]
    return out


def orth(P: torch.Tensor, how: dict) -> torch.Tensor:
    """Orthonormal columns spanning each (m, r) panel of a stack (E, m, r)."""
    if how["method"] == "qr":
        return torch.linalg.qr(P)[0]
    out = torch.zeros_like(P)
    for j in range(P.shape[-1]):
        v = P[..., j:j + 1]
        if j:
            U = out[..., :j]
            for _ in range(2):       # classical Gram-Schmidt, twice over
                v = v - U @ (U.transpose(-1, -2) @ v)
        out[..., j:j + 1] = v / (torch.linalg.vector_norm(v, dim=-2, keepdim=True)
                                 + how["eps"])
    return out


def orth_all(P: dict, how: dict) -> dict:
    """``orth`` of every panel, stacked by shape."""
    by: dict[tuple, list[str]] = {}
    for k, v in P.items():
        by.setdefault(tuple(v.shape), []).append(k)
    out = {}
    for ks in by.values():
        for k, o in zip(ks, orth(torch.stack([P[k] for k in ks]), how)):
            out[k] = o
    return out


def lr_at(a: dict, step: int) -> float:
    lr, warm, total = a["lr"], a["warmup_steps"], a["total_steps"]
    if step < warm:
        return lr * step / max(1, warm)
    prog = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    return lr * (a["min_lr_frac"] + (1 - a["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog)))


def grads(m, u, tokens, labels, mm, block_tokens: int = 4096):
    """(mean loss, gradients) of the rows, accumulated over row blocks."""
    rows, T = tokens.shape
    per = max(1, block_tokens // T)
    total = torch.zeros((), dtype=F32, device=tokens.device)
    g = {k: torch.zeros_like(v) for k, v in u.items()}
    for lo in range(0, rows, per):
        tok, lab = tokens[lo:lo + per], labels[lo:lo + per]
        w = tok.shape[0] / rows
        with torch.enable_grad():
            leaf = {k: v.detach().requires_grad_(True) for k, v in u.items()}
            loss = ref_model.loss(m, leaf, tok, lab, mm)
            gs = torch.autograd.grad(loss, list(leaf.values()))
        total += w * loss.detach()
        for k, gi in zip(leaf, gs):
            g[k].add_(gi, alpha=w)
    return total, g


def gaussian_entropy(m: dict, synced: dict, beta: float) -> float:
    """Lemma 2 on the pooled strided beta-sample of every leaf of more
    than 16 elements, each leaf flattened as the port's tree stacks it."""
    by_leaf: dict[tuple, list[str]] = {}
    for name, leaf in weights.unit_leaf(m).items():
        by_leaf.setdefault(leaf.path, []).append(name)
    n = s1 = s2 = 0.0
    for leaf in weights.leaves(m):
        names = by_leaf[leaf.path]
        flat = (torch.stack([synced[k] for k in names]) if leaf.stacked
                else synced[names[0]]).reshape(-1)
        if flat.numel() <= 16:
            continue
        k = flat.numel() if beta >= 1.0 else max(1, int(flat.numel() * beta))
        stride = max(1, flat.numel() // k)
        x = flat[: stride * k: stride].double()
        n += x.numel()
        s1 += float(x.sum())
        s2 += float((x * x).sum())
    var = max(s2 / n - (s1 / n) ** 2, 0.0)
    return math.log(math.sqrt(var) + 1e-12) + 0.5 * (math.log(2 * math.pi) + 1.0)


@torch.no_grad()
def run(m: dict, mix: dict, u0: dict, batches: list[dict], seed: int,
        steps: int = 3, mm=ref_model.matmul) -> dict:
    """``steps`` steps from the units ``u0`` (fp32) on ``batches`` (global
    batches, rows split over ``mix["replicas"]``). Returns the losses, the
    entropy of each gated step, the clipped first gradient's norm per unit
    and each unit's change over the steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = next(iter(u0.values())).device
    R, a, gds = mix.get("replicas", 1), mix["adam"], mix["gds"]
    every = max(1, round(1.0 / gds["alpha"]))
    leaf_of = weights.unit_leaf(m)
    q = warm_q(m, mix, seed, device)
    ef = [{k: torch.zeros_like(u0[k]) for k in q} for _ in range(R)]
    p = {k: v.clone() for k, v in u0.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = a["betas"]
    store = getattr(torch, m["dtype"])
    out = {"loss": [], "entropy": {}, "grad_norm": {}, "change_norm": {}}
    for t in range(steps):
        tok, lab = batches[t]["tokens"], batches[t]["labels"]
        per = tok.shape[0] // R
        losses, g = [], []
        for r in range(R):
            lo, gr = grads(m, p, tok[r * per:(r + 1) * per], lab[r * per:(r + 1) * per], mm)
            losses.append(lo)
            g.append(gr)
        out["loss"].append(float(sum(losses) / R))
        M = {k: [g[r][k] + ef[r][k] for r in range(R)] for k in q}
        P_hat = orth_all({k: sum(Mr @ q[k] for Mr in M[k]) / R for k in q},
                         mix["orthonormalisation"])
        synced = {}
        for k in p:
            if k in q:
                q[k] = sum(Mr.t() @ P_hat[k] for Mr in M[k]) / R
                synced[k] = P_hat[k] @ q[k].t()
                for r in range(R):
                    ef[r][k] = M[k][r] - synced[k]
            else:
                synced[k] = sum(g[r][k] for r in range(R)) / R
        del M, P_hat
        del g
        if (t % mix["dac"]["window"]) % every == 0:
            out["entropy"][t] = gaussian_entropy(m, synced, gds["beta"])
        gnorm = math.sqrt(sum(float((s * s).sum()) for s in synced.values()))
        scale = min(1.0, a["grad_clip"] / (gnorm + 1e-12)) if a["grad_clip"] > 0 else 1.0
        lr = lr_at(a, t + 1)
        c1, c2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
        for k in p:
            g32 = synced[k] * scale
            if t == 0:
                out["grad_norm"][k] = float(torch.linalg.vector_norm(g32))
            mom[k].mul_(b1).add_(g32, alpha=1 - b1)
            vel[k].mul_(b2).add_(g32 * g32, alpha=1 - b2)
            upd = (mom[k] / c1) / (torch.sqrt(vel[k] / c2) + a["eps"])
            if a["weight_decay"] > 0 and len(leaf_of[k].shape) >= 2:
                upd = upd + a["weight_decay"] * p[k]
            p[k].sub_(lr * upd)
            p[k].copy_(p[k].to(store))
    for k in p:
        out["change_norm"][k] = float(torch.linalg.vector_norm(p[k] - u0[k]))
    return out
