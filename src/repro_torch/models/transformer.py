"""Dense decoder-only transformer family (port of ``repro/models/transformer.py``).

Covers the GPT-2 family of the paper (LayerNorm, plain GeLU, learned
positions, tied embeddings, MHA) and the qwen2-style options (RMSNorm,
RoPE, GQA, QKV bias, gated SiLU). Block parameters are stacked per virtual
pipeline stage under ``['stages'][s]['blocks']``, every leaf with a leading
layer dim, exactly as in the reference; the forward loops over the stack
where the reference scans it. ``cfg.remat`` checkpoints each block with
``torch.utils.checkpoint``.

Decoding (``init_cache``/``decode_step``) runs one token for the whole
batch against a KV cache stacked per stage like the blocks. The reference
cannot decode a learned-position config (its ``embed_tokens`` sends the
0-d cache length to a ``vmap`` branch that raises); the port adds
position ``cache_len``'s row of ``pos_embed``, which is what that code
means.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.dist import tp
from . import layers as L
from .model import Model, ModelConfig, register_family

F32 = torch.float32


# ----------------------------------------------------------------------- init
def _stack_init(gen, cfg: ModelConfig, n: int) -> dict[str, Any]:
    """n stacked blocks: every leaf has a leading layer dim."""
    dt = cfg.torch_dtype
    ones = lambda: torch.ones((n, cfg.d_model), dtype=dt)
    p: dict[str, Any] = {
        "attn_norm_scale": ones(),
        "attn": L.attn_init(gen, n, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.hd, dt, cfg.qkv_bias,
                            cfg.qk_norm),
        "mlp_norm_scale": ones(),
        "mlp": L.mlp_init(gen, n, cfg.d_model, cfg.d_ff, dt,
                          gated=cfg.act in ("silu", "gelu"),
                          bias=cfg.norm == "layernorm"),
    }
    if cfg.norm == "layernorm":
        p["attn_norm_bias"] = torch.zeros((n, cfg.d_model), dtype=dt)
        p["mlp_norm_bias"] = torch.zeros((n, cfg.d_model), dtype=dt)
    return p


@torch.no_grad()
def init(cfg: ModelConfig, seed: int, device) -> dict[str, Any]:
    """Random parameters on ``device``, drawn from a CPU generator seeded
    with ``seed``: one seed gives the same weights on every device, as
    ``jax.random`` does in the reference."""
    return tree.tree_map(lambda t: t.to(device), _init_cpu(cfg, seed))


def _init_cpu(cfg: ModelConfig, seed: int) -> dict[str, Any]:
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.torch_dtype
    params: dict[str, Any] = {
        "embed": {"tok": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt)},
        "stages": [{"blocks": _stack_init(gen, cfg, sz)}
                   for sz in cfg.stage_sizes()],
        "final_norm_scale": torch.ones((cfg.d_model,), dtype=dt),
    }
    if cfg.norm == "layernorm":
        params["final_norm_bias"] = torch.zeros((cfg.d_model,), dtype=dt)
    if cfg.pos == "learned":
        pos = torch.randn((cfg.max_position, cfg.d_model), generator=gen,
                          dtype=F32)
        params["pos_embed"] = (pos * 0.01).to(dt)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return params


# -------------------------------------------------------------------- forward
def _norm(x, p, prefix, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return L.layer_norm(x, p[f"{prefix}_scale"], p[f"{prefix}_bias"],
                            cfg.norm_eps)
    return L.rms_norm(x, p[f"{prefix}_scale"], cfg.norm_eps)


def _block_apply(bp, x, cfg: ModelConfig, positions, window: int):
    h = _norm(x, bp, "attn_norm", cfg)
    h = L.attn_apply(
        bp["attn"], h, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.hd, causal=True, positions=positions,
        rope_theta=cfg.rope_theta, use_rope=(cfg.pos == "rope"),
        window=window, norm_eps=cfg.norm_eps, block_q=cfg.block_q,
    )
    x = x + h
    h = _norm(x, bp, "mlp_norm", cfg)
    h = L.mlp_apply(bp["mlp"], h, act="gelu" if "gelu" in cfg.act else "silu")
    return x + h


def apply_block_stack(blocks, x, cfg: ModelConfig, positions, window: int):
    """Run one stacked set of decoder blocks (one pipeline stage's worth)."""
    block = lambda bp, x, cfg: _block_apply(bp, x, cfg, positions, window)
    return L.apply_units(block, blocks, x, cfg)


def embed_tokens(params, tokens, cfg: ModelConfig, offset=0):
    """Token embeddings plus, for learned positions, ``pos_embed`` rows
    ``offset + arange(T)``. A tensor ``offset`` (0-d, or one per batch row)
    stays on the device; its start is clamped to ``max_position - T``, as
    ``jax.lax.dynamic_slice_in_dim`` clamps."""
    x = L.embedding(tokens, params["embed"]["tok"])
    if cfg.pos == "learned":
        T = tokens.shape[-1]
        if isinstance(offset, torch.Tensor):
            start = torch.clamp(offset, max=params["pos_embed"].shape[0] - T)
            rows = start[..., None] + torch.arange(T, device=tokens.device)
            x = x + F.embedding(rows, params["pos_embed"])
        else:
            x = x + params["pos_embed"][offset: offset + T]
    return x


def final_logits(params, x, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        x = L.layer_norm(x, params["final_norm_scale"], params["final_norm_bias"],
                         cfg.norm_eps)
    else:
        x = L.rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    w = params["embed"]["tok"] if cfg.tie_embeddings else params["lm_head"]
    return L.lm_logits(x, w, tie=cfg.tie_embeddings)


def forward(params, batch, cfg: ModelConfig):
    tokens = batch["tokens"]
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = embed_tokens(params, tokens, cfg)
    for stage in params["stages"]:
        x = apply_block_stack(stage["blocks"], x, cfg, positions,
                              cfg.sliding_window)
    return final_logits(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    logits = forward(params, batch, cfg)
    loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss}


# --------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device):
    """Per-stage stacked (L_s, B, C, Hkv, Dh) K/V caches and the 0-d int32
    length; C is the window under ``sliding_window``, else ``max_len``."""
    C = cfg.sliding_window if cfg.sliding_window > 0 else max_len
    zeros = lambda n: torch.zeros((n, batch_size, C, cfg.num_kv_heads, cfg.hd),
                                  dtype=cfg.torch_dtype, device=device)
    return {"stages": [{"k": zeros(n), "v": zeros(n)}
                       for n in cfg.stage_sizes()],
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def decode_units(units, caches, x, fn):
    """``x = fn(unit_i, x, cache_i)`` over a stacked tree's units; each
    ``cache_i`` is a view of one layer of the stacked ``caches``, so what
    ``fn`` writes into it lands in the stack."""
    flat = tree.leaves(caches)
    stacks = [tp.whole_dim0(a) for a in tree.leaves(units)] + flat
    for xs in zip(*(a.unbind(0) for a in stacks)):
        n = len(xs) - len(flat)
        x = fn(tree.unflatten(units, xs[:n]), x,
               tree.unflatten(caches, xs[n:]))
    return x


def attn_decode_cfg(p, h, k, v, cache_len, cfg: ModelConfig,
                    use_rope: bool):
    """``layers.attn_decode`` with the config's widths and window; returns
    the attention's output (the caches ``k``/``v`` are written in place)."""
    return L.attn_decode(
        p, h, k, v, cache_len, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, use_rope=use_rope,
        window=cfg.sliding_window, norm_eps=cfg.norm_eps)[0]


@torch.no_grad()
def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One token for the whole batch: tokens (B,) -> logits (B, V) fp32.

    The new K/V rows are written into ``cache``'s tensors, which the
    returned cache holds (as the donated train step reuses its state):
    the cache passed in is consumed. Its ``len`` is a new 0-d tensor."""
    cache_len = cache["len"]
    x = embed_tokens(params, tokens[:, None], cfg, offset=cache_len)
    act = "gelu" if "gelu" in cfg.act else "silu"

    def block(bp, x, kv):
        h = _norm(x, bp, "attn_norm", cfg)
        x = x + attn_decode_cfg(bp["attn"], h, kv["k"], kv["v"], cache_len,
                                cfg, use_rope=(cfg.pos == "rope"))
        return x + L.mlp_apply(bp["mlp"], _norm(x, bp, "mlp_norm", cfg), act)

    for stage, sc in zip(params["stages"], cache["stages"]):
        x = decode_units(stage["blocks"], sc, x, block)
    logits = final_logits(params, x, cfg)[:, 0]
    return logits, {"stages": cache["stages"], "len": cache_len + 1}


@register_family("dense")
def build(cfg: ModelConfig) -> Model:
    return Model(
        config=cfg,
        init=lambda seed, device: init(cfg, seed, device),
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        forward=lambda p, b: forward(p, b, cfg),
        init_cache=lambda bs, max_len=None, *, device: init_cache(
            cfg, bs, max_len if max_len else 32768, device),
        decode_step=lambda p, c, t: decode_step(p, c, t, cfg),
    )
