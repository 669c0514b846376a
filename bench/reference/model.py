"""Decoder-only transformer forward and next-token loss, plain torch, fp32.

Two block kinds, chosen by the configuration's fields:

* GPT-2 (``norm: layernorm``, ``act: gelu_plain``, ``pos: learned``):
  x = tok[t] + pos[i]; per layer h = LN(x), x += softmax(q k^T / sqrt(dh),
  causal) v W_o with q, k, v = h W_q, h W_k, h W_v; h = LN(x), x +=
  gelu_tanh(h W_up + b_up) W_down + b_down; logits = LN(x) tok^T.
* Qwen2 (``norm: rmsnorm``, ``act: silu``, ``pos: rope``, ``qkv_bias``):
  RMSNorm, q, k, v with biases, rotary positions (rotate-half, theta from
  the configuration) on q and k, grouped-query attention (query head h
  reads KV head h // (H / Hkv)), SwiGLU silu(h W_gate) * (h W_up) W_down.

Departure from the published GPT-2 (as the configuration states): no
attention biases. Every product goes through ``mm`` (``torch.matmul`` by
default) so that the control can run the same model at a lower precision.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import weights


def matmul(a, b):
    return torch.matmul(a, b)


def _norm(m, u, x, prefix):
    if m["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + m["norm_eps"]) * u[prefix + "_scale"] \
            + u[prefix + "_bias"]
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + m["norm_eps"]) \
        * u[prefix + "_scale"]


def _rope(x, theta: float):
    """x: (B, T, H, dh), rotate-half convention, positions 0..T-1."""
    T, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=x.device) / dh))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _block(m, u, l, mm, x):
    p = f"L{l}."
    B, T, d = x.shape
    H, Hkv, dh = m["num_heads"], m["num_kv_heads"], weights.head_dim(m)
    h = _norm(m, u, x, p + "attn_norm")
    q, k, v = (mm(h, u[p + f"attn.w{c}"]) for c in "qkv")
    if m["qkv_bias"]:
        q, k, v = q + u[p + "attn.q_bias"], k + u[p + "attn.k_bias"], v + u[p + "attn.v_bias"]
    q, k, v = q.view(B, T, H, dh), k.view(B, T, Hkv, dh), v.view(B, T, Hkv, dh)
    if m["pos"] == "rope":
        q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    rep = H // Hkv
    q = q.transpose(1, 2)                                       # B H T dh
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    a = torch.softmax(s.masked_fill(causal, float("-inf")), dim=-1)
    o = mm(a, v).transpose(1, 2).reshape(B, T, H * dh)
    x = x + mm(o, u[p + "attn.wo"])
    h = _norm(m, u, x, p + "mlp_norm")
    if weights.gated(m):
        f = F.silu(mm(h, u[p + "mlp.gate"])) * mm(h, u[p + "mlp.up"])
    else:
        f = F.gelu(mm(h, u[p + "mlp.up"]) + u[p + "mlp.up_bias"], approximate="tanh")
    y = mm(f, u[p + "mlp.down"])
    if not weights.gated(m):
        y = y + u[p + "mlp.down_bias"]
    return x + y


def loss(m: dict, u: dict, tokens, labels, mm=matmul, remat: bool = True):
    """Mean next-token cross entropy of the rows ``tokens`` (B, T)."""
    T = tokens.shape[1]
    x = F.embedding(tokens, u["embed.tok"])
    if m["pos"] == "learned":
        x = x + u["pos_embed"][:T]
    for l in range(m["num_layers"]):
        fn = lambda y, l=l: _block(m, u, l, mm, y)
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    x = _norm(m, u, x, "final_norm")
    head = u["embed.tok"].t() if m["tie_embeddings"] else u["lm_head"]
    logits = mm(x, head)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
