"""Recurrent families (port of ``repro/models/ssm.py``): xLSTM (mLSTM and
sLSTM blocks) and Mamba2 blocks.

The shared core is a *chunked linear recurrence*

    S_t = a_t * S_{t-1} + k_t (x) v_t          (matrix state per head)
    y_t = q_t . S_t

evaluated chunk-parallel: intra-chunk terms are an attention-like product
with a decay mask D_ts = exp(Lambda_t - Lambda_s) (Lambda = cumsum log a),
and the inter-chunk terms flow through a loop over the T / chunk chunk
states (the reference's ``lax.scan``). mLSTM adds a normaliser channel;
Mamba2 derives its decay from dt * A.

The reference's numerics are kept as they are, defects included:

  * mLSTM's exponential input gate runs as ``sigmoid(i_raw)`` in the
    chunked path; sLSTM has the true exponential gating with the m
    stabiliser, in a sequential loop over T (one step of about twenty
    small kernels per token);
  * the intra-chunk decay takes ``exp`` of the whole (t, s) difference
    before masking the upper triangle, ``where(tri, exp(ldiff), 0)``. Once
    a chunk's summed log-decay passes about 88 the masked entries are inf,
    and the backward multiplies them by zero: the gradient is NaN while
    the forward is finite, in both packages.

Stacked parameters carry a leading layer dim, as every family's do: the
xLSTM (mLSTM, sLSTM) pairs under ``['stages'][s]['pairs']`` and the Mamba2
layers of the hybrid family under ``['stages'][s]['mamba']``. The gates,
recurrences, ``dt`` and ``log_a`` run in fp32, and ``gate_bias``,
``a_log``, ``dt_bias`` and ``d_skip`` are fp32 leaves under any
``cfg.dtype``.

Decoding carries a constant-size state per layer: the recurrence's fp32
matrix state and the causal conv's last k - 1 inputs (mLSTM, Mamba2), or
the sLSTM's h, c, n and m. ``*_decode`` updates the state tensors it is
given in place and returns them.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.dist import tp
from . import layers as L
from .model import (Model, ModelConfig, concat_stage_stacks, near_even_split,
                    register_family)

F32 = torch.float32


# ------------------------------------------------------------- linear recurrence
def chunked_linear_recurrence(q, k, v, log_a, chunk: int, s0=None):
    """y_t = q_t . S_t with S_t = a_t S_{t-1} + k_t (x) v_t, chunk-parallel.

    q, k: (B, T, H, Dk); v: (B, T, H, Dv); log_a: (B, T, H) (<= 0).
    Returns (y (B, T, H, Dv), S_final (B, H, Dk, Dv)), both fp32.
    T must be a multiple of ``chunk`` (callers pad).
    """
    B, T, H, Dk = q.shape
    Dv = v.shape[-1]
    assert T % chunk == 0, (T, chunk)
    N = T // chunk
    qc = q.reshape(B, N, chunk, H, Dk).to(F32)
    kc = k.reshape(B, N, chunk, H, Dk).to(F32)
    vc = v.reshape(B, N, chunk, H, Dv).to(F32)
    la = log_a.reshape(B, N, chunk, H).to(F32)
    La = torch.cumsum(la, dim=2)                      # (B,N,C,H) inclusive

    # intra-chunk: D_ts = exp(La_t - La_s) for s <= t, masked after the exp
    scores = torch.einsum("bnthk,bnshk->bnhts", qc, kc)
    ldiff = (La[..., :, None, :] - La[..., None, :, :]).permute(0, 1, 4, 2, 3)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    decay = torch.where(tri, torch.exp(ldiff), 0.0)
    y_intra = torch.einsum("bnhts,bnshv->bnthv", scores * decay, vc)

    # inter-chunk: a loop over the chunk-final states
    if s0 is None:
        s0 = torch.zeros((B, H, Dk, Dv), dtype=F32, device=q.device)
    La_end = La[:, :, -1, :]                          # (B,N,H)
    # per-chunk input to the state: sum_s exp(La_end - La_s) k_s v_s
    w = torch.exp(La_end[:, :, None, :] - La)         # (B,N,C,H)
    chunk_in = torch.einsum("bnshk,bnshv->bnhkv", kc * w[..., None], vc)
    chunk_decay = torch.exp(La_end)                   # (B,N,H)
    # unbind, not an index per chunk: its backward stacks the N slices'
    # gradients once instead of writing each into a zero-filled copy
    s, s_prevs = s0, []
    for cin, cdec in zip(chunk_in.unbind(1), chunk_decay.unbind(1)):
        s_prevs.append(s)
        s = cdec[..., None, None] * s + cin
    s_prevs = torch.stack(s_prevs, dim=1)             # state at chunk start
    qw = qc * torch.exp(La)[..., None]                # q_t decayed from chunk start
    y_cross = torch.einsum("bnthk,bnhkv->bnthv", qw, s_prevs)

    y = (y_intra + y_cross).reshape(B, T, H, Dv)
    return y, s


def recurrence_decode(q, k, v, log_a, s):
    """One-token update, in place: q, k (B, H, Dk), v (B, H, Dv), log_a
    (B, H); s (B, H, Dk, Dv) fp32 becomes a s + k (x) v. Returns (y, s)."""
    a = torch.exp(log_a.to(F32))[..., None, None]
    s.mul_(a).add_(torch.einsum("bhk,bhv->bhkv", k.to(F32), v.to(F32)))
    y = torch.einsum("bhk,bhkv->bhv", q.to(F32), s)
    return y, s


def _pad_time(pad: int, *arrays):
    """Zero-pad dim 1 (time) of each array at its end."""
    return [F.pad(a, [0, 0] * (a.ndim - 2) + [0, pad]) for a in arrays]


# ---------------------------------------------------------------- causal conv
def causal_conv_init(gen, n: int, channels: int, kernel: int, dtype):
    w = torch.randn((n, kernel, channels), generator=gen, dtype=F32)
    return {"w": (w / math.sqrt(kernel)).to(dtype),
            "b": torch.zeros((n, channels), dtype=dtype)}


def causal_conv_apply(p, x):
    """Depthwise causal conv along T. x: (B, T, C)."""
    k, T = p["w"].shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    w = p["w"].to(F32)
    out = sum(xp[:, i: i + T] * w[i] for i in range(k))
    return (out + p["b"].to(F32)).to(x.dtype)


def causal_conv_decode(p, x_t, tail):
    """x_t: (B, C) the new input; tail: (B, k-1, C) the previous inputs,
    shifted in place to end with x_t. Returns (out, tail)."""
    window = torch.cat([tail, x_t[:, None].to(tail.dtype)], dim=1)   # (B,k,C)
    out = torch.einsum("bkc,kc->bc", window.to(F32), p["w"].to(F32))
    out = out + p["b"].to(F32)
    tail.copy_(window[:, 1:])
    return out.to(x_t.dtype), tail


# ======================================================================= mLSTM
def mlstm_init(gen, n: int, cfg: ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    d_inner = 2 * d
    H = cfg.num_heads
    dt = cfg.torch_dtype
    ones = lambda width: torch.ones((n, width), dtype=dt)
    bias = torch.cat([torch.zeros((H,), dtype=F32),
                      3.0 * torch.ones((H,), dtype=F32)])
    return {
        "norm_scale": ones(d),
        "up_x": L.dense_init(gen, (n, d, d_inner), dt),
        "up_z": L.dense_init(gen, (n, d, d_inner), dt),
        "conv": causal_conv_init(gen, n, d_inner, cfg.conv_kernel, dt),
        "wq": L.dense_init(gen, (n, d_inner, d_inner), dt),
        "wk": L.dense_init(gen, (n, d_inner, d_inner), dt),
        "wv": L.dense_init(gen, (n, d_inner, d_inner), dt),
        "w_gates": L.dense_init(gen, (n, d_inner, 2 * H), dt),  # i, f per head
        "gate_bias": bias.expand(n, 2 * H).clone(),
        "head_norm_scale": ones(d_inner),
        "down": L.dense_init(gen, (n, d_inner, d), dt),
    }


def _mlstm_project(p, xc, xz):
    """q, k, v (..., d_inner) and the gates' pre-activations i, f (..., H)."""
    q = L._mm("...d,de->...e", xc, p["wq"])
    k = L._mm("...d,de->...e", xc, p["wk"])
    v = L._mm("...d,de->...e", xz, p["wv"])
    gates = L._mm("...d,de->...e", xc, p["w_gates"]) + p["gate_bias"]
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)        # (..., H)
    return q, k, v, i_raw, f_raw


def _mlstm_heads(q, k, v, i_raw, f_raw):
    """q, k, v heads and the per-head log decay (input gate folded into
    k); the head count is the gates' last dim."""
    H = i_raw.shape[-1]
    dh = q.shape[-1] // H
    i_gate = torch.sigmoid(i_raw)                       # stabilised input gate
    log_a = F.logsigmoid(f_raw)                         # log forget/decay
    shape = tuple(q.shape[:-1]) + (H, dh)
    scale = 1.0 / math.sqrt(dh)
    return (q.reshape(shape) * scale, k.reshape(shape) * i_gate[..., None],
            v.reshape(shape), log_a)


def _mlstm_mix(q, k, v, i_raw, f_raw, chunk: int, dtype):
    """The mLSTM's chunked recurrence with its normaliser channel over
    (B, T, H * dh) projections: (B, T, H * dh) in ``dtype``. Heads are
    independent, so under tensor parallelism it runs on local heads."""
    B, T = q.shape[:2]
    q, k, v, log_a = _mlstm_heads(q, k, v, i_raw, f_raw)
    # normaliser channel: a column of ones appended to v
    v_aug = torch.cat([v, torch.ones(tuple(v.shape[:-1]) + (1,),
                                     dtype=v.dtype, device=v.device)], dim=-1)
    pad = (-T) % chunk
    if pad:
        q, k, v_aug, log_a = _pad_time(pad, q, k, v_aug, log_a)
    y_aug, _ = chunked_linear_recurrence(q, k, v_aug, log_a, chunk)
    y_aug = y_aug[:, :T]
    y, norm = y_aug[..., :-1], y_aug[..., -1:]
    y = y / torch.maximum(torch.abs(norm), torch.ones_like(norm))
    return y.reshape(B, T, -1).to(dtype)


def _conv_silu(x, w, b):
    return F.silu(causal_conv_apply({"w": w, "b": b}, x).to(F32)).to(x.dtype)


def mlstm_apply(p, x, cfg: ModelConfig):
    """x: (B, T, d). Matrix-memory LSTM with a normaliser channel.

    Under tensor parallelism the up projections are column-split; the
    conv input is gathered (the q/k products and the replicated gate
    product read it whole), and the recurrence runs on local heads where
    the model axis divides them (``tp.local_map``)."""
    h = L.rms_norm(x, p["norm_scale"], cfg.norm_eps)
    xz = L._mm("btd,de->bte", h, p["up_z"]).to(x.dtype)
    xc = L._mm("btd,de->bte", h, p["up_x"]).to(x.dtype)
    xc = tp.local_map(_conv_silu, (xc,), (p["conv"]["w"], p["conv"]["b"]))
    q, k, v, i_raw, f_raw = _mlstm_project(p, xc, xz)
    heads = lambda t: tp.gather_unless_divides(t, -1, cfg.num_heads)
    y = tp.local_map(
        lambda *a: _mlstm_mix(*a, cfg.chunk, x.dtype),
        (heads(q), heads(k), heads(v), i_raw, f_raw), split_dim=2)
    y = L.rms_norm(y, p["head_norm_scale"], cfg.norm_eps)
    y = y * F.silu(xz.to(F32)).to(x.dtype)
    out = L._mm("bte,ed->btd", y, p["down"])
    return x + out.to(x.dtype)


def mlstm_decode(p, x_t, state, cfg: ModelConfig):
    """x_t: (B, d); state: {'s': (B, H, Dk, Dv + 1), 'conv': (B, k-1,
    d_inner)}, updated in place. Under tensor parallelism the conv and the
    recurrence run on local tensors (``tp.local_map``) over every head,
    which the state holds."""
    h = L.rms_norm(x_t, p["norm_scale"], cfg.norm_eps)
    xz = L._mm("bd,de->be", h, p["up_z"]).to(x_t.dtype)
    xc = L._mm("bd,de->be", h, p["up_x"]).to(x_t.dtype)
    new = {}

    def conv(xc, w, b):
        xc, new["conv"] = causal_conv_decode({"w": w, "b": b}, xc,
                                             state["conv"])
        return F.silu(xc.to(F32)).to(x_t.dtype)

    def mix(*qkv_gates):
        q, k, v, log_a = _mlstm_heads(*qkv_gates)
        v_aug = torch.cat([v, torch.ones(tuple(v.shape[:-1]) + (1,),
                                         dtype=v.dtype, device=v.device)],
                          dim=-1)
        y_aug, new["s"] = recurrence_decode(q, k, v_aug, log_a, state["s"])
        y, norm = y_aug[..., :-1], y_aug[..., -1:]
        y = y / torch.maximum(torch.abs(norm), torch.ones_like(norm))
        return y.reshape(q.shape[0], -1).to(x_t.dtype)

    xc = tp.local_map(conv, (xc,), (p["conv"]["w"], p["conv"]["b"]))
    y = tp.local_map(mix, _mlstm_project(p, xc, xz))
    y = L.rms_norm(y, p["head_norm_scale"], cfg.norm_eps)
    y = y * F.silu(xz.to(F32)).to(x_t.dtype)
    out = L._mm("be,ed->bd", y, p["down"])
    return x_t + out.to(x_t.dtype), {"s": new["s"], "conv": new["conv"]}


def mlstm_state_init(cfg: ModelConfig, batch: int, device):
    d_inner = 2 * cfg.d_model
    dh = d_inner // cfg.num_heads
    return {
        "s": torch.zeros((batch, cfg.num_heads, dh, dh + 1), dtype=F32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, d_inner),
                            dtype=cfg.torch_dtype, device=device),
    }


# ======================================================================= sLSTM
def slstm_init(gen, n: int, cfg: ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    dt = cfg.torch_dtype
    d_ff = int(d * 4 / 3 / 2) * 2  # xLSTM proj factor 4/3, even
    r = torch.randn((n, H, dh, 4 * dh), generator=gen, dtype=F32)
    bias = torch.cat([torch.zeros((2 * d,), dtype=F32),
                      3.0 * torch.ones((d,), dtype=F32),
                      torch.zeros((d,), dtype=F32)])
    return {
        "norm_scale": torch.ones((n, d), dtype=dt),
        "w_in": L.dense_init(gen, (n, d, 4 * d), dt),   # z, i, f, o pre-acts
        "r_blocks": (r / math.sqrt(dh)).to(dt),          # block-diag recurrence
        "gate_bias": bias.expand(n, 4 * d).clone(),
        "head_norm_scale": torch.ones((n, d), dtype=dt),
        "ffn_norm_scale": torch.ones((n, d), dtype=dt),
        "ffn": L.mlp_init(gen, n, d, d_ff, dt, gated=True),
    }


def _slstm_cell(r32, gate_bias, x_pre, h_prev, c_prev, n_prev, m_prev,
                H: int):
    """One sLSTM step with exponential gating and the m stabiliser.

    ``r32``: the recurrence blocks in fp32 (H, dh, 4 dh); x_pre: (B, 4d)
    input pre-activations; h/c/n/m: (B, d). Returns (h, c, n, m).
    """
    B, d4 = x_pre.shape
    d = d4 // 4
    hh = h_prev.reshape(B, H, d // H)
    rec = torch.einsum("bhd,hde->bhe", hh.to(F32), r32)
    pre = x_pre.to(F32) + rec.reshape(B, 4 * d) + gate_bias
    z_raw, i_raw, f_raw, o_raw = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z_raw)
    o = torch.sigmoid(o_raw)
    log_f = F.logsigmoid(f_raw)                 # exp-gate via log-sigmoid form
    m = torch.maximum(log_f + m_prev, i_raw)
    i_s = torch.exp(i_raw - m)
    f_s = torch.exp(log_f + m_prev - m)
    c = f_s * c_prev + i_s * z
    n = f_s * n_prev + i_s
    h = o * c / torch.clamp(n, min=1e-6)
    return h, c, n, m


def _slstm_scan(x_pre, r_blocks, gate_bias, H: int, dtype):
    """The sLSTM's loop over T from zero state: (B, T, 4d) input
    pre-activations -> (B, T, d) hidden states in ``dtype``."""
    B, _, d4 = x_pre.shape
    r32 = r_blocks.to(F32)
    h = torch.zeros((B, d4 // 4), dtype=F32, device=x_pre.device)
    c, n, m = h, h, h - 10.0
    hs = []
    for x_t in x_pre.unbind(1):      # (B, 4d) per token, one backward stack
        h, c, n, m = _slstm_cell(r32, gate_bias, x_t, h, c, n, m, H)
        hs.append(h)
    return torch.stack(hs, dim=1).to(dtype)


def slstm_apply(p, x, cfg: ModelConfig):
    """x: (B, T, d): a sequential loop over T (sLSTM is recurrent). Under
    tensor parallelism ``w_in`` and the recurrence are replicated and the
    loop runs on local tensors (``tp.local_map``): about twenty ops a
    token, none of them through DTensor's dispatch."""
    hx = L.rms_norm(x, p["norm_scale"], cfg.norm_eps)
    x_pre = L._mm("btd,de->bte", hx, p["w_in"])
    y = tp.local_map(
        lambda xp, r, b: _slstm_scan(xp, r, b, cfg.num_heads, x.dtype),
        (x_pre,), (p["r_blocks"], p["gate_bias"]))
    y = L.rms_norm(y, p["head_norm_scale"], cfg.norm_eps)
    x = x + y
    h2 = L.rms_norm(x, p["ffn_norm_scale"], cfg.norm_eps)
    return x + L.mlp_apply(p["ffn"], h2, act="silu")


def slstm_decode(p, x_t, state, cfg: ModelConfig):
    """x_t: (B, d); state: h, c, n, m, each (B, d) fp32, updated in place
    (the cell on local tensors under tensor parallelism, as the loop of
    ``slstm_apply``)."""
    hx = L.rms_norm(x_t, p["norm_scale"], cfg.norm_eps)
    x_pre = L._mm("bd,de->be", hx, p["w_in"])

    def cell(x_pre, r_blocks, gate_bias):
        new = _slstm_cell(r_blocks.to(F32), gate_bias, x_pre, state["h"],
                          state["c"], state["n"], state["m"], cfg.num_heads)
        for key, val in zip("hcnm", new):
            state[key].copy_(val)
        return state["h"].to(x_t.dtype)

    y = tp.local_map(cell, (x_pre,), (p["r_blocks"], p["gate_bias"]))
    y = L.rms_norm(y, p["head_norm_scale"], cfg.norm_eps)
    x = x_t + y
    h2 = L.rms_norm(x, p["ffn_norm_scale"], cfg.norm_eps)
    return x + L.mlp_apply(p["ffn"], h2, act="silu"), state


def slstm_state_init(cfg: ModelConfig, batch: int, device):
    z = lambda: torch.zeros((batch, cfg.d_model), dtype=F32, device=device)
    return {"h": z(), "c": z(), "n": z(), "m": z() - 10.0}


def stacked_state(state: dict, n: int) -> dict:
    """``n`` copies of a state tree, stacked on a leading layer dim."""
    return tree.tree_map(lambda a: a.expand((n,) + a.shape).clone(), state)


# ================================================================ xLSTM model
def xlstm_stage_sizes(cfg: ModelConfig) -> list[int]:
    """(mLSTM, sLSTM) pairs per virtual pipeline stage, near-even split.

    The pair, not the layer, is the stage-assignable unit: splitting one
    would separate an mLSTM from its sLSTM partner.
    """
    n_pairs = cfg.num_layers // 2
    return near_even_split(n_pairs, min(cfg.num_stages, n_pairs))


@torch.no_grad()
def xlstm_init(cfg: ModelConfig, seed: int, device) -> dict[str, Any]:
    """Random parameters on ``device``, drawn on the CPU from a generator
    seeded with ``seed`` (the same weights on every device)."""
    assert cfg.num_layers % 2 == 0, "xlstm stacks (mLSTM, sLSTM) pairs"
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.torch_dtype
    to = lambda t: tree.tree_map(lambda a: a.to(device), t)
    return {
        "embed": {"tok": to(L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt))},
        "stages": [
            {"pairs": to({"mlstm": mlstm_init(gen, sz, cfg),
                          "slstm": slstm_init(gen, sz, cfg)})}
            for sz in xlstm_stage_sizes(cfg)
        ],
        "final_norm_scale": torch.ones((cfg.d_model,), dtype=dt,
                                       device=device),
        "lm_head": to(L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)),
    }


def pair_apply(pair, x, cfg: ModelConfig):
    """One (mLSTM, sLSTM) pair."""
    x = mlstm_apply(pair["mlstm"], x, cfg)
    return slstm_apply(pair["slstm"], x, cfg)


def xlstm_forward(params, batch, cfg: ModelConfig):
    x = L.embedding(batch["tokens"], params["embed"]["tok"])
    pairs = concat_stage_stacks([st["pairs"] for st in params["stages"]])
    x = L.apply_units(pair_apply, pairs, x, cfg)
    x = L.rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    return L.lm_logits(x, params["lm_head"], tie=False)


def xlstm_loss(params, batch, cfg: ModelConfig):
    logits = xlstm_forward(params, batch, cfg)
    loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss}


def xlstm_cache_init(cfg: ModelConfig, batch: int, device):
    """Every pair's mLSTM and sLSTM state, stacked over all pairs."""
    n_pairs = cfg.num_layers // 2
    return {"mlstm": stacked_state(mlstm_state_init(cfg, batch, device),
                                   n_pairs),
            "slstm": stacked_state(slstm_state_init(cfg, batch, device),
                                   n_pairs),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def _state_views(stack: dict, i: int) -> dict:
    return {k: v[i] for k, v in stack.items()}


@torch.no_grad()
def xlstm_decode(params, cache, tokens, cfg: ModelConfig):
    """One token for the batch; the states are updated in place and the
    returned cache holds them (the cache passed in is consumed)."""
    x = L.embedding(tokens, params["embed"]["tok"])            # (B, d)
    i = 0
    for stage in params["stages"]:
        pairs = stage["pairs"]
        for leaves in zip(*(a.unbind(0) for a in tree.leaves(pairs))):
            pair = tree.unflatten(pairs, leaves)
            x, _ = mlstm_decode(pair["mlstm"], x,
                                _state_views(cache["mlstm"], i), cfg)
            x, _ = slstm_decode(pair["slstm"], x,
                                _state_views(cache["slstm"], i), cfg)
            i += 1
    x = L.rms_norm(x, params["final_norm_scale"], cfg.norm_eps)
    logits = L._mm("bd,dv->bv", x, params["lm_head"])
    return logits, {"mlstm": cache["mlstm"], "slstm": cache["slstm"],
                    "len": cache["len"] + 1}


@register_family("xlstm")
def _build_xlstm(cfg: ModelConfig) -> Model:
    return Model(
        config=cfg,
        init=lambda seed, device: xlstm_init(cfg, seed, device),
        loss_fn=lambda p, b: xlstm_loss(p, b, cfg),
        forward=lambda p, b: xlstm_forward(p, b, cfg),
        init_cache=lambda bs, max_len=0, *, device: xlstm_cache_init(
            cfg, bs, device),
        decode_step=lambda p, c, t: xlstm_decode(p, c, t, cfg),
    )


# ====================================================================== Mamba2
def _mamba2_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, state size n, heads H): heads of dimension 64."""
    d_inner = 2 * cfg.d_model
    return d_inner, cfg.ssm_state, d_inner // 64


def mamba2_init(gen, n_layers: int, cfg: ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    d_inner, n, H = _mamba2_dims(cfg)
    dt = cfg.torch_dtype
    full = lambda v: torch.full((n_layers, H), v, dtype=F32)
    return {
        "norm_scale": torch.ones((n_layers, d), dtype=dt),
        "in_proj": L.dense_init(gen, (n_layers, d, 2 * d_inner + 2 * n + H),
                                dt),
        "conv": causal_conv_init(gen, n_layers, d_inner + 2 * n,
                                 cfg.conv_kernel, dt),
        "a_log": full(0.0),                                 # A = -exp(a_log)
        "dt_bias": torch.log(torch.expm1(full(0.01))),
        "d_skip": full(1.0),
        "out_norm_scale": torch.ones((n_layers, d_inner), dtype=dt),
        "out_proj": L.dense_init(gen, (n_layers, d_inner, d), dt),
    }


def _mamba2_split(zxbcdt, dtype, cfg: ModelConfig):
    """[z | x B C | dt] of the input projection: z and dt in fp32, the
    conv's input in ``dtype``."""
    d_inner, n, H = _mamba2_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: 2 * d_inner + 2 * n].to(dtype)
    dt_raw = zxbcdt[..., -H:]
    return z, xbc, dt_raw


def _mamba2_ssm_inputs(p, xbc, dt_raw, cfg: ModelConfig):
    d_inner, n, H = _mamba2_dims(cfg)
    x = xbc[..., :d_inner]
    b = xbc[..., d_inner: d_inner + n]
    c = xbc[..., d_inner + n:]
    dt = F.softplus(dt_raw + p["dt_bias"])                 # (..., H) > 0
    log_a = -dt * torch.exp(p["a_log"])                    # (..., H) <= 0
    lead = tuple(x.shape[:-1])
    xh = x.reshape(lead + (H, 64))
    # B and C shared across heads (n_groups = 1): broadcast, not copied;
    # the input is scaled by dt per head
    k = b[..., None, :].expand(lead + (H, n))
    q = c[..., None, :].expand(lead + (H, n))
    v = xh * dt[..., None]
    return q, k, v, log_a, xh


def _mamba2_mix(zxbcdt, conv_w, conv_b, a_log, dt_bias, d_skip, out_norm,
                cfg: ModelConfig, dtype):
    """Everything between the two projections: the conv, the SSD
    recurrence, the D skip, the z gate and the gated norm, on (B, T,
    2 d_inner + 2n + H) -> (B, T, d_inner) in ``dtype``."""
    B, T = zxbcdt.shape[:2]
    p = {"a_log": a_log, "dt_bias": dt_bias}
    z, xbc, dt_raw = _mamba2_split(zxbcdt, dtype, cfg)
    xbc = _conv_silu(xbc, conv_w, conv_b)
    q, k, v, log_a, xh = _mamba2_ssm_inputs(p, xbc, dt_raw, cfg)
    pad = (-T) % cfg.chunk
    if pad:
        q, k, v, log_a = _pad_time(pad, q, k, v, log_a)
    y, _ = chunked_linear_recurrence(q, k, v, log_a, cfg.chunk)
    y = y[:, :T] + d_skip[:, None] * xh.to(F32)            # D skip per head
    y = y.reshape(B, T, -1)
    y = y * F.silu(z)
    return L.rms_norm(y.to(dtype), out_norm, cfg.norm_eps)


def mamba2_apply(p, x, cfg: ModelConfig):
    """Under tensor parallelism ``in_proj`` is column-split over the
    concatenated [z | x B C | dt], whose slices cut across its shards:
    its output is gathered over ``model`` (as GSPMD gathers it), the
    layer between the projections runs whole on local tensors
    (``tp.local_map``), and ``y`` is cut locally for the row-parallel
    ``out_proj``."""
    h = L.rms_norm(x, p["norm_scale"], cfg.norm_eps)
    zxbcdt = L._mm("...d,de->...e", h, p["in_proj"])
    y = tp.local_map(
        lambda *a: _mamba2_mix(*a, cfg, x.dtype), (zxbcdt,),
        (p["conv"]["w"], p["conv"]["b"], p["a_log"], p["dt_bias"],
         p["d_skip"], p["out_norm_scale"]))
    y = tp.split_rows_for(y, p["out_proj"])
    out = L._mm("bte,ed->btd", y, p["out_proj"])
    return x + out.to(x.dtype)


_MAMBA2_STEP_WEIGHTS = ("a_log", "dt_bias", "d_skip", "out_norm_scale")


def mamba2_decode(p, x_t, state, cfg: ModelConfig):
    """x_t: (B, d); state: {'s': (B, H, n, 64) fp32, 'conv': (B, k-1,
    d_inner + 2n)}, updated in place. Under tensor parallelism the step
    between the projections runs whole on local tensors
    (``tp.local_map``), as ``mamba2_apply``'s mix does, and the state
    holds this process's batch rows."""
    h = L.rms_norm(x_t, p["norm_scale"], cfg.norm_eps)
    zxbcdt = L._mm("...d,de->...e", h, p["in_proj"])
    new = {}

    def step(zx, conv_w, conv_b, *weights):
        q = dict(zip(_MAMBA2_STEP_WEIGHTS, weights),
                 conv={"w": conv_w, "b": conv_b})
        z, xbc, dt_raw = _mamba2_split(zx, h.dtype, cfg)
        xbc, new["conv"] = causal_conv_decode(q["conv"], xbc, state["conv"])
        xbc = F.silu(xbc.to(F32)).to(x_t.dtype)
        qk, k, v, log_a, xh = _mamba2_ssm_inputs(q, xbc, dt_raw, cfg)
        y, new["s"] = recurrence_decode(qk, k, v, log_a, state["s"])
        y = y + q["d_skip"][:, None] * xh.to(F32)
        y = y.reshape(zx.shape[0], -1)
        y = y * F.silu(z)
        return L.rms_norm(y.to(x_t.dtype), q["out_norm_scale"], cfg.norm_eps)

    y = tp.local_map(step, (zxbcdt,),
                     (p["conv"]["w"], p["conv"]["b"],
                      *(p[k] for k in _MAMBA2_STEP_WEIGHTS)))
    y = tp.split_rows_for(y, p["out_proj"])
    out = L._mm("be,ed->bd", y, p["out_proj"])
    return x_t + out.to(x_t.dtype), {"s": new["s"], "conv": new["conv"]}


def mamba2_state_init(cfg: ModelConfig, batch: int, device):
    d_inner, n, H = _mamba2_dims(cfg)
    return {
        "s": torch.zeros((batch, H, n, 64), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, d_inner + 2 * n),
                            dtype=cfg.torch_dtype, device=device),
    }
