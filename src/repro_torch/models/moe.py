"""Mixture-of-Experts decoder family (port of ``repro/models/moe.py``).

GShard-style dispatch: tokens are flattened and re-grouped into fixed-size
groups; each group builds a (S, E, C) dispatch/combine pair by top-k
routing with a capacity factor, and the expert FFN is three batched
products over the (E, d, f) expert stacks. The router runs in fp32
whatever ``cfg.dtype`` says. Router aux loss: Switch-style load
balancing, E * sum_e f_e * p_e.

EDGC note: the expert weights are (L, E, d, f) leaves, compressed per
expert by the batched PowerSGD path; the router is excluded (small and
sensitive to routing noise), as in the reference. Block parameters are
stacked per stage under ``['stages'][s]['blocks']``; the head is an
untied ``lm_head``. Decoding routes the batch's B tokens as one group at
capacity C = B, so no token is dropped there (the forward drops at
``capacity_factor``).

Where the reference's primitives differ from torch's, the port keeps the
reference's meaning: ``jax.lax.top_k`` breaks ties toward the lower
expert index (a stable descending sort here), and ``jax.nn.one_hot`` maps
the out-of-range queue position C to a zero row (``torch``'s raises; the
slot mask here compares positions with ``arange(C)``). The routing's
one-hots compare with ``arange(E)`` too: ``F.one_hot`` reads its input's
range back to the host on the CPU (two host syncs a call, which the
collective audit flags).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import tree
from repro_torch.dist import tp
from . import layers as L
from . import transformer as TF
from .model import Model, ModelConfig, register_family

F32 = torch.float32


# ----------------------------------------------------------------------- init
def moe_ffn_init(gen, n: int, cfg: ModelConfig) -> dict[str, Any]:
    """n stacked MoE FFNs: an fp32 (d, E) router and (E, d, f) experts."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    router = torch.randn((n, d, E), generator=gen, dtype=F32) * 0.02
    return {
        "router": router,
        "experts": {
            "gate": L.dense_init(gen, (n, E, d, f), dt),
            "up": L.dense_init(gen, (n, E, d, f), dt),
            "down": L.dense_init(gen, (n, E, f, d), dt),
        },
    }


def _stack_init(gen, cfg: ModelConfig, n: int) -> dict[str, Any]:
    dt = cfg.torch_dtype
    return {
        "attn_norm_scale": torch.ones((n, cfg.d_model), dtype=dt),
        "attn": L.attn_init(gen, n, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.hd, dt, cfg.qkv_bias,
                            cfg.qk_norm),
        "mlp_norm_scale": torch.ones((n, cfg.d_model), dtype=dt),
        "moe": moe_ffn_init(gen, n, cfg),
    }


@torch.no_grad()
def init(cfg: ModelConfig, seed: int, device) -> dict[str, Any]:
    """Random parameters on ``device``, drawn leaf by leaf from a CPU
    generator seeded with ``seed`` (the same weights on every device)."""
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.torch_dtype
    to = lambda t: tree.tree_map(lambda a: a.to(device), t)
    return {
        "embed": {"tok": to(L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt))},
        "stages": [{"blocks": to(_stack_init(gen, cfg, sz))}
                   for sz in cfg.stage_sizes()],
        "final_norm_scale": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "lm_head": to(L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)),
    }


# ------------------------------------------------------------------- routing
def capacity_of(cfg: ModelConfig, group: int) -> int:
    """Expert capacity C of a dispatch group of ``group`` tokens (the
    reference's Python float rule)."""
    k = cfg.experts_per_token
    return max(k, int(group * k / cfg.num_experts * cfg.capacity_factor))  # lint: allow(host-call-in-hot-path) capacity from static config numbers


def route(x_flat, ffn, cfg: ModelConfig, group_size: int,
          capacity: int | None = None, mean=None):
    """Top-k dispatch/combine for flattened tokens (N, d).

    Returns (grouped tokens (G, S, d), dispatch (G, S, E, C) bool, combine
    (G, S, E, C) fp32, aux loss). ``capacity`` overrides the
    capacity-factor rule. Tokens past the last whole group (a ragged
    tail) are not routed. ``mean`` turns the aux loss's per-expert means
    over these groups into means over every group of the batch (the
    identity when ``x_flat`` is the whole batch).
    """
    N, d = x_flat.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    S = min(group_size, N)
    G = max(1, N // S)
    xg = x_flat[: G * S].reshape(G, S, d)
    logits = torch.einsum("gsd,de->gse", xg.to(F32), ffn["router"].to(F32))
    probs = torch.softmax(logits, dim=-1)                        # (G,S,E)
    # jax.lax.top_k: ties go to the lower index (a stable descending sort)
    top_idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[..., :k]           # (G,S,k)
    top_vals = torch.gather(probs, -1, top_idx)
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)

    C = capacity if capacity is not None else capacity_of(cfg, S)
    loc = torch.zeros((G, E), dtype=torch.int64, device=x_flat.device)
    dispatch = torch.zeros((G, S, E, C), dtype=torch.bool,
                           device=x_flat.device)
    combine = torch.zeros((G, S, E, C), dtype=F32, device=x_flat.device)
    slots = torch.arange(C, device=x_flat.device)
    experts = torch.arange(E, device=x_flat.device)
    one_hot = lambda idx: (idx[..., None] == experts).to(torch.int64)
    for i in range(k):
        oh = one_hot(top_idx[..., i])                            # (G,S,E)
        pos = torch.cumsum(oh, dim=1) - oh + loc[:, None, :]     # queue position
        loc = loc + torch.sum(oh, dim=1)
        keep = (pos < C) & (oh > 0)
        # the reference's one_hot(where(keep, pos, C), C): a dropped or
        # unrouted slot is a zero row
        d_i = keep[..., None] & (pos[..., None] == slots)
        dispatch = dispatch | d_i
        combine = combine + top_vals[..., i, None, None] * d_i.to(F32)

    # Switch load-balance aux: E * sum_e fraction_e * mean_prob_e
    assign1 = one_hot(top_idx[..., 0]).to(F32)
    f_e = torch.mean(assign1, dim=(0, 1))
    p_e = torch.mean(probs, dim=(0, 1))
    if mean is not None:
        f_e, p_e = mean(f_e), mean(p_e)
    aux = E * torch.sum(f_e * p_e)
    return xg, dispatch, combine, aux


def moe_ffn_apply(ffn, x, cfg: ModelConfig, group_size: int = 1024,
                  capacity: int | None = None):
    """x: (B, T, d) -> (B, T, d), plus the router aux loss.

    Under tensor parallelism (DTensor ``x`` and parameters) the routing
    runs on this process's batch rows with the replicated router (on the
    whole batch where a dispatch group would straddle the batch split),
    and the expert products on the expert-split stacks under DTensor (on
    the model sub-mesh where the rows are split over data axes)."""
    B, T, d = x.shape
    rows = tp.BatchSplit(x)
    if (rows.local.shape[0] * T) % min(group_size, B * T):
        # the batch's dispatch groups straddle the split: route them whole
        rows = tp.BatchSplit(x, split=False)
    x_loc = rows.local
    x_flat = x_loc.reshape(x_loc.shape[0] * T, d)
    router = ffn["router"]
    if isinstance(router, DTensor):
        router = router.redistribute(
            router.device_mesh, (Replicate(),) * len(router.placements)
        ).to_local(grad_placements=rows.partial)
    xg, dispatch, combine, aux = route(x_flat, {"router": router}, cfg,
                                       group_size, capacity, mean=rows.mean)
    w = ffn["experts"]
    sub = tp.rows_submesh(rows)
    if sub is None:
        place = rows.wrap
    else:
        # FSDP + TP (mode "auto"): these rows' expert products run on the
        # model sub-mesh, as under dp_tp (DTensor cannot view the dispatch
        # groups split over the data axes)
        w = {k: tp.to_submesh(v, rows, sub) for k, v in w.items()}
        place = lambda t: DTensor.from_local(t, sub, (Replicate(),),
                                             run_check=False)
    xg, dispatch, combine = (place(t) for t in (xg, dispatch, combine))
    G, S, E, C = combine.shape
    ein = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    gate = L._mm("gecd,edf->gecf", ein, w["gate"])
    up = L._mm("gecd,edf->gecf", ein, w["up"])
    h = (F.silu(gate) * up).to(x.dtype)
    eout = L._mm("gecf,efd->gecd", h, w["down"])
    yg = torch.einsum("gsec,gecd->gsd", combine, eout)
    y = yg.reshape(G * S, d)
    if sub is not None:
        y = y.redistribute(sub, (Replicate(),)).to_local()
    n = x_flat.shape[0]
    if G * S < n:  # ragged tail (only when the tokens are not a multiple of S)
        y = torch.cat([y, y.new_zeros((n - G * S, d))], 0)
    if sub is not None:
        return rows.wrap(y.reshape(x_loc.shape)).to(x.dtype), aux
    return y.reshape(B, T, d).to(x.dtype), aux


# -------------------------------------------------------------------- forward
def _block_apply(bp, x, cfg: ModelConfig, positions, window: int):
    h = L.rms_norm(x, bp["attn_norm_scale"], cfg.norm_eps)
    h = L.attn_apply(
        bp["attn"], h, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.hd, causal=True, positions=positions,
        rope_theta=cfg.rope_theta, use_rope=True, window=window,
        norm_eps=cfg.norm_eps, block_q=cfg.block_q,
    )
    x = x + h
    h = L.rms_norm(x, bp["mlp_norm_scale"], cfg.norm_eps)
    h, aux = moe_ffn_apply(bp["moe"], h, cfg, group_size=cfg.moe_group)
    return x + h, aux


def forward(params, batch, cfg: ModelConfig, return_aux: bool = False):
    tokens = batch["tokens"]
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = L.embedding(tokens, params["embed"]["tok"])
    aux_total = torch.zeros((), dtype=F32, device=x.device)

    def block(bp, carry, cfg):
        x, aux = _block_apply(bp, carry[0], cfg, positions, cfg.sliding_window)
        return x, carry[1] + aux

    for stage in params["stages"]:
        x, aux_total = L.apply_units(block, stage["blocks"], (x, aux_total),
                                     cfg)
    x = L.rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    logits = L.lm_logits(x, params["lm_head"], tie=False)
    if return_aux:
        return logits, aux_total / max(1, cfg.num_layers)
    return logits


def loss_fn(params, batch, cfg: ModelConfig):
    logits, aux = forward(params, batch, cfg, return_aux=True)
    ce = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"loss": ce, "aux": aux}


# --------------------------------------------------------------------- decode
@torch.no_grad()
def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One token for the batch; the cache is written in place, as the
    dense family's (``transformer.decode_step``)."""
    B = tokens.shape[0]
    cache_len = cache["len"]
    x = L.embedding(tokens[:, None], params["embed"]["tok"])

    def block(bp, x, kv):
        h = L.rms_norm(x, bp["attn_norm_scale"], cfg.norm_eps)
        x = x + TF.attn_decode_cfg(bp["attn"], h, kv["k"], kv["v"], cache_len,
                                   cfg, use_rope=True)
        h = L.rms_norm(x, bp["mlp_norm_scale"], cfg.norm_eps)
        # full capacity (C = B): no token is ever dropped
        y, _ = moe_ffn_apply(bp["moe"], h, cfg, group_size=B, capacity=B)
        return x + y

    for stage, sc in zip(params["stages"], cache["stages"]):
        x = TF.decode_units(stage["blocks"], sc, x, block)
    x = L.rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    logits = L.lm_logits(x, params["lm_head"], tie=False)[:, 0]
    return logits, {"stages": cache["stages"], "len": cache_len + 1}


@register_family("moe")
def build(cfg: ModelConfig) -> Model:
    return Model(
        config=cfg,
        init=lambda seed, device: init(cfg, seed, device),
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        forward=lambda p, b: forward(p, b, cfg),
        init_cache=lambda bs, max_len=32768, *, device: TF.init_cache(
            cfg, bs, max_len, device),
        decode_step=lambda p, c, t: decode_step(p, c, t, cfg),
    )
