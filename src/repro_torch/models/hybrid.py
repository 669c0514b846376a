"""Zamba2-style hybrid (port of ``repro/models/hybrid.py``): a Mamba2
backbone and one SHARED attention block applied periodically through the
depth.

``num_layers`` Mamba2 layers are grouped into runs of ``attn_every``; after
each run the shared attention + MLP block (one parameter set, reused)
is applied. The Mamba2 layers live under ``params['stages'][s]['mamba']``,
stacked per stage; stage boundaries fall on group boundaries (a run and
its shared-attention site stay whole), so per-stage layer counts are
generally ragged, and ``stage_group_sizes`` is the one source of the
group -> stage assignment. The shared block sits at top level under
``params['shared']``.

Decoding carries each Mamba2 layer's state (SSM state and conv tail) and
one K/V cache per shared-attention site: the parameters are shared, the
caches are not.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tree
from . import layers as L
from . import ssm
from . import transformer as TF
from .model import Model, ModelConfig, near_even_split, register_family


def _num_groups(cfg: ModelConfig) -> int:
    return (cfg.num_layers + cfg.attn_every - 1) // cfg.attn_every


def _group_sizes(cfg: ModelConfig) -> list[int]:
    return near_even_split(cfg.num_layers, _num_groups(cfg))


def stage_group_sizes(cfg: ModelConfig, num_stages: int | None = None
                      ) -> list[list[int]]:
    """Per-stage list of mamba-run lengths (whole groups per stage).

    Groups are assigned to stages contiguously, near-even by group count;
    each group is one mamba run followed by a shared-attention site.
    """
    sizes = _group_sizes(cfg)
    S = min(num_stages or cfg.num_stages, len(sizes))
    out, i = [], 0
    for n in near_even_split(len(sizes), S):
        out.append(sizes[i: i + n])
        i += n
    return out


@torch.no_grad()
def init(cfg: ModelConfig, seed: int, device) -> dict[str, Any]:
    """Random parameters on ``device``, drawn on the CPU from a generator
    seeded with ``seed`` (the same weights on every device)."""
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.torch_dtype
    to = lambda t: tree.tree_map(lambda a: a.to(device), t)
    one = lambda t: tree.tree_map(lambda a: a[0], t)   # an unstacked block
    stages = [{"mamba": to(ssm.mamba2_init(gen, sum(sizes), cfg))}
              for sizes in stage_group_sizes(cfg)]
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=device)
    return {
        "embed": {"tok": to(L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt))},
        "stages": stages,
        "shared": {
            "attn_norm_scale": ones(),
            "attn": to(one(L.attn_init(gen, 1, cfg.d_model, cfg.num_heads,
                                       cfg.num_kv_heads, cfg.hd, dt))),
            "mlp_norm_scale": ones(),
            "mlp": to(one(L.mlp_init(gen, 1, cfg.d_model, cfg.d_ff, dt,
                                     gated=True))),
        },
        "final_norm_scale": ones(),
        "lm_head": to(L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)),
    }


def shared_apply(sp, x, cfg: ModelConfig, positions):
    """The shared attention + MLP block at one site."""
    h = L.rms_norm(x, sp["attn_norm_scale"], cfg.norm_eps)
    h = L.attn_apply(
        sp["attn"], h, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.hd, causal=True, positions=positions,
        rope_theta=cfg.rope_theta, use_rope=True, window=cfg.sliding_window,
        norm_eps=cfg.norm_eps, block_q=cfg.block_q,
    )
    x = x + h
    h = L.rms_norm(x, sp["mlp_norm_scale"], cfg.norm_eps)
    return x + L.mlp_apply(sp["mlp"], h, act="silu")


def forward(params, batch, cfg: ModelConfig):
    tokens = batch["tokens"]
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = L.embedding(tokens, params["embed"]["tok"])
    for stage, sizes in zip(params["stages"], stage_group_sizes(cfg)):
        off = 0
        for sz in sizes:
            run = tree.tree_map(lambda a: a[off: off + sz], stage["mamba"])
            off += sz
            x = L.apply_units(ssm.mamba2_apply, run, x, cfg)
            x = shared_apply(params["shared"], x, cfg, positions)
    x = L.rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    return L.lm_logits(x, params["lm_head"], tie=False)


def loss_fn(params, batch, cfg: ModelConfig):
    logits = forward(params, batch, cfg)
    loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Per group: its Mamba2 layers' states stacked, and the group's own
    (B, C, Hkv, Dh) K/V cache of the shared attention."""
    C = cfg.sliding_window if cfg.sliding_window > 0 else max_len
    kv = lambda: torch.zeros((batch, C, cfg.num_kv_heads, cfg.hd),
                             dtype=cfg.torch_dtype, device=device)
    groups = [{"mamba": ssm.stacked_state(
                   ssm.mamba2_state_init(cfg, batch, device), sz),
               "attn_k": kv(), "attn_v": kv()}
              for sz in _group_sizes(cfg)]
    return {"groups": groups,
            "len": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One token for the batch; every state and cache is updated in place
    and the returned cache holds them (the cache passed in is consumed)."""
    cache_len = cache["len"]
    x = L.embedding(tokens, params["embed"]["tok"])            # (B, d)
    sp = params["shared"]
    mamba = lambda m, h, st: ssm.mamba2_decode(m, h, st, cfg)[0]
    groups = iter(cache["groups"])
    for stage, sizes in zip(params["stages"], stage_group_sizes(cfg)):
        off = 0
        for sz in sizes:
            gc = next(groups)
            run = tree.tree_map(lambda a: a[off: off + sz], stage["mamba"])
            off += sz
            x = TF.decode_units(run, gc["mamba"], x, mamba)
            # the shared attention on the single token
            h = L.rms_norm(x[:, None], sp["attn_norm_scale"], cfg.norm_eps)
            x1 = x[:, None] + TF.attn_decode_cfg(
                sp["attn"], h, gc["attn_k"], gc["attn_v"], cache_len, cfg,
                use_rope=True)
            h = L.rms_norm(x1, sp["mlp_norm_scale"], cfg.norm_eps)
            x = (x1 + L.mlp_apply(sp["mlp"], h, act="silu"))[:, 0]
    x = L.rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    logits = L._mm("bd,dv->bv", x, params["lm_head"])
    return logits, {"groups": cache["groups"], "len": cache_len + 1}


@register_family("zamba")
def _build(cfg: ModelConfig) -> Model:
    return Model(
        config=cfg,
        init=lambda seed, device: init(cfg, seed, device),
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        forward=lambda p, b: forward(p, b, cfg),
        init_cache=lambda bs, max_len=32768, *, device: init_cache(
            cfg, bs, max_len, device),
        decode_step=lambda p, c, t: decode_step(p, c, t, cfg),
    )
