"""Whisper-style encoder-decoder (port of ``repro/models/encdec.py``).

The modality frontend (mel-spectrogram and conv feature extractor) is a
stub: the batch provides precomputed frame embeddings ``frames`` (B,
audio_frames, d_model). The backbone is a bidirectional encoder over the
frames (sinusoidal positions) and a causal decoder with cross-attention
(learned positions), trained with teacher forcing; the head is tied to
``embed.tok``.

The stub frames are fp32, and ``frames + sinusoidal_pos(..., frames.dtype)``
keeps the encoder stream in fp32 under bf16 weights (``layers._mm``
promotes mixed operands as ``jnp.einsum`` does), as in the reference.

Encoder and decoder blocks live under ``params['stages'][s]`` as
``enc_blocks`` and ``dec_blocks``: encoder stages first, decoder stages
after (``stage_layout``); ``num_stages == 1`` keeps both halves in one
stage.

Decoding carries the decoder's self-attention K/V cache and the cross K/V
of the encoder memory, computed once by ``init_cache`` when it is given
the parameters and the frames (or the encoder's output).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tree
from . import layers as L
from . import transformer as TF
from .model import (Model, ModelConfig, concat_stage_stacks, near_even_split,
                    register_family)

F32 = torch.float32


def _enc_block_init(gen, n: int, cfg: ModelConfig) -> dict[str, Any]:
    dt = cfg.torch_dtype
    ones = lambda: torch.ones((n, cfg.d_model), dtype=dt)
    zeros = lambda: torch.zeros((n, cfg.d_model), dtype=dt)
    return {
        "attn_norm_scale": ones(),
        "attn_norm_bias": zeros(),
        "attn": L.attn_init(gen, n, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.hd, dt),
        "mlp_norm_scale": ones(),
        "mlp_norm_bias": zeros(),
        "mlp": L.mlp_init(gen, n, cfg.d_model, cfg.d_ff, dt, gated=False,
                          bias=True),
    }


def _dec_block_init(gen, n: int, cfg: ModelConfig) -> dict[str, Any]:
    dt = cfg.torch_dtype
    p = _enc_block_init(gen, n, cfg)
    p["cross_norm_scale"] = torch.ones((n, cfg.d_model), dtype=dt)
    p["cross_norm_bias"] = torch.zeros((n, cfg.d_model), dtype=dt)
    p["cross"] = L.attn_init(gen, n, cfg.d_model, cfg.num_heads,
                             cfg.num_kv_heads, cfg.hd, dt)
    return p


def stage_layout(cfg: ModelConfig, num_stages: int | None = None
                 ) -> list[dict[str, int]]:
    """Per-stage {'enc': n, 'dec': n} layer counts.

    Encoder stages come first, decoder stages after (pipeline order: the
    cross-attention memory flows forward from the last encoder stage). The
    enc/dec split of the stage budget is proportional to layer counts;
    ``num_stages == 1`` keeps both halves in the single stage.
    """
    Le = cfg.encoder_layers or cfg.num_layers
    Ld = cfg.num_layers
    S = max(1, num_stages or cfg.num_stages)
    if S == 1:
        return [{"enc": Le, "dec": Ld}]
    S = min(S, Le + Ld)
    s_e = int(round(S * Le / max(1, Le + Ld)))  # lint: allow(host-call-in-hot-path) host-side stage split
    s_e = max(1, min(s_e, S - 1, Le))
    s_d = S - s_e
    if s_d > Ld:                      # more dec stages than dec layers
        s_d = Ld
        s_e = min(S - s_d, Le)
    return ([{"enc": n, "dec": 0} for n in near_even_split(Le, s_e)]
            + [{"enc": 0, "dec": n} for n in near_even_split(Ld, s_d)])


@torch.no_grad()
def init(cfg: ModelConfig, seed: int, device) -> dict[str, Any]:
    """Random parameters on ``device``, drawn on the CPU from a generator
    seeded with ``seed`` (the same weights on every device)."""
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.torch_dtype
    stages = []
    for counts in stage_layout(cfg):
        st = {}
        if counts["enc"]:
            st["enc_blocks"] = _enc_block_init(gen, counts["enc"], cfg)
        if counts["dec"]:
            st["dec_blocks"] = _dec_block_init(gen, counts["dec"], cfg)
        stages.append(st)
    pos = torch.randn((cfg.max_position, cfg.d_model), generator=gen,
                      dtype=F32)
    params = {
        "stages": stages,
        "enc_norm_scale": torch.ones((cfg.d_model,), dtype=dt),
        "enc_norm_bias": torch.zeros((cfg.d_model,), dtype=dt),
        "embed": {"tok": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt)},
        "dec_pos": (pos * 0.01).to(dt),
        "final_norm_scale": torch.ones((cfg.d_model,), dtype=dt),
        "final_norm_bias": torch.zeros((cfg.d_model,), dtype=dt),
    }
    return tree.tree_map(lambda a: a.to(device), params)


def _cat_blocks(params, key: str):
    """Concatenate per-stage block stacks back to one (L, ...) tree."""
    return concat_stage_stacks(
        [st[key] for st in params["stages"] if key in st])


def _ln(x, p, prefix, cfg: ModelConfig):
    return L.layer_norm(x, p[f"{prefix}_scale"], p[f"{prefix}_bias"],
                        cfg.norm_eps)


def embed_frames(frames):
    """The encoder's input: frames plus sinusoidal positions, in the
    frames' dtype."""
    _, S, d = frames.shape
    return frames + L.sinusoidal_pos(S, d, frames.dtype, frames.device)


def embed_tokens(params, tokens):
    """The decoder's input: token embeddings plus learned positions."""
    x = L.embedding(tokens, params["embed"]["tok"])
    return x + params["dec_pos"][: tokens.shape[1]]


def enc_block_apply(bp, h, cfg: ModelConfig):
    positions = torch.arange(h.shape[1], device=h.device).expand(h.shape[:2])
    a = _ln(h, bp, "attn_norm", cfg)
    a = L.attn_apply(bp["attn"], a, num_heads=cfg.num_heads,
                     num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
                     causal=False, positions=positions, use_rope=False,
                     norm_eps=cfg.norm_eps, block_q=cfg.block_q)
    h = h + a
    m = _ln(h, bp, "mlp_norm", cfg)
    return h + L.mlp_apply(bp["mlp"], m, act="gelu")


def dec_block_apply(bp, h, mem, cfg: ModelConfig):
    """One decoder block over the encoder memory ``mem``."""
    positions = torch.arange(h.shape[1], device=h.device).expand(h.shape[:2])
    a = _ln(h, bp, "attn_norm", cfg)
    a = L.attn_apply(bp["attn"], a, num_heads=cfg.num_heads,
                     num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
                     causal=True, positions=positions, use_rope=False,
                     norm_eps=cfg.norm_eps, block_q=cfg.block_q)
    h = h + a
    c = _ln(h, bp, "cross_norm", cfg)
    ek, ev = L.cross_kv(bp["cross"], mem, num_kv_heads=cfg.num_kv_heads,
                        head_dim=cfg.hd)
    c = L.cross_attn_apply(bp["cross"], c, ek, ev, num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd)
    h = h + c
    m = _ln(h, bp, "mlp_norm", cfg)
    return h + L.mlp_apply(bp["mlp"], m, act="gelu")


def encode(params, frames, cfg: ModelConfig):
    """frames: (B, S, d), the stubbed conv frontend's output."""
    x = L.apply_units(enc_block_apply, _cat_blocks(params, "enc_blocks"),
                      embed_frames(frames), cfg)
    return _ln(x, params, "enc_norm", cfg)


def decode_train(params, tokens, enc_out, cfg: ModelConfig):
    dec = lambda bp, h, cfg: dec_block_apply(bp, h, enc_out, cfg)
    x = L.apply_units(dec, _cat_blocks(params, "dec_blocks"),
                      embed_tokens(params, tokens), cfg)
    x = _ln(x, params, "final_norm", cfg)
    return L.lm_logits(x, params["embed"]["tok"], tie=True)  # whisper ties


def forward(params, batch, cfg: ModelConfig):
    enc_out = encode(params, batch["frames"], cfg)
    return decode_train(params, batch["tokens"], enc_out, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    logits = forward(params, batch, cfg)
    loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_out=None,
               frames=None, params=None, *, device):
    """The decode cache: the (Ld, B, max_len, Hkv, Dh) self-attention K/V,
    the (Ld, B, audio_frames, Hkv, Dh) cross K/V and the 0-d length. Given
    ``params`` and ``frames`` (or ``enc_out``) the cross K/V are the
    encoder memory's, one per decoder block, in the memory's dtype (fp32
    from the fp32 stub frames); else zeros."""
    dt = cfg.torch_dtype
    shape = lambda T: (cfg.num_layers, batch, T, cfg.num_kv_heads, cfg.hd)
    zeros = lambda T: torch.zeros(shape(T), dtype=dt, device=device)
    cache = {"k": zeros(max_len), "v": zeros(max_len),
             "cross_k": zeros(cfg.audio_frames),
             "cross_v": zeros(cfg.audio_frames),
             "len": torch.zeros((), dtype=torch.int32, device=device)}
    if params is not None and (enc_out is not None or frames is not None):
        with torch.no_grad():
            if enc_out is None:
                enc_out = encode(params, frames, cfg)
            kvs = [L.cross_kv(bp, enc_out, num_kv_heads=cfg.num_kv_heads,
                              head_dim=cfg.hd)
                   for blocks in _dec_stacks(params)
                   for bp in _units(blocks["cross"])]
        cache["cross_k"] = torch.stack([k for k, _ in kvs])
        cache["cross_v"] = torch.stack([v for _, v in kvs])
    return cache


def _dec_stacks(params) -> list:
    """Each stage's stacked decoder blocks, in order."""
    return [st["dec_blocks"] for st in params["stages"] if "dec_blocks" in st]


def _units(stack):
    """The unstacked units of a stacked tree."""
    return [tree.unflatten(stack, xs)
            for xs in zip(*(a.unbind(0) for a in tree.leaves(stack)))]


@torch.no_grad()
def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One token for the batch; the self-attention K/V are written in place
    and the returned cache holds them (the cache passed in is consumed).
    The position row is ``dec_pos[cache_len]``, clamped to the last row as
    ``jax.lax.dynamic_slice_in_dim`` clamps."""
    cache_len = cache["len"]
    x = L.embedding(tokens[:, None], params["embed"]["tok"])
    pos = torch.clamp(cache_len, max=params["dec_pos"].shape[0] - 1)
    x = x + F.embedding(pos.reshape(1), params["dec_pos"])

    def block(bp, h, c):
        a = _ln(h, bp, "attn_norm", cfg)
        a = L.attn_decode(bp["attn"], a, c["k"], c["v"], cache_len,
                          num_heads=cfg.num_heads,
                          num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
                          use_rope=False, norm_eps=cfg.norm_eps)[0]
        h = h + a
        a = _ln(h, bp, "cross_norm", cfg)
        a = L.cross_attn_apply(bp["cross"], a, c["cross_k"], c["cross_v"],
                               num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd)
        h = h + a
        m = _ln(h, bp, "mlp_norm", cfg)
        return h + L.mlp_apply(bp["mlp"], m, act="gelu")

    off = 0
    for blocks in _dec_stacks(params):
        n = tree.leaves(blocks)[0].shape[0]
        kv = {key: cache[key][off: off + n]
              for key in ("k", "v", "cross_k", "cross_v")}
        x = TF.decode_units(blocks, kv, x, block)
        off += n
    x = _ln(x, params, "final_norm", cfg)
    logits = L.lm_logits(x, params["embed"]["tok"], tie=True)[:, 0]
    return logits, {**cache, "len": cache_len + 1}


@register_family("whisper")
def _build(cfg: ModelConfig) -> Model:
    return Model(
        config=cfg,
        init=lambda seed, device: init(cfg, seed, device),
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        forward=lambda p, b: forward(p, b, cfg),
        init_cache=lambda bs, max_len=448, *, device: init_cache(
            cfg, bs, max_len, device=device),
        decode_step=lambda p, c, t: decode_step(p, c, t, cfg),
    )
