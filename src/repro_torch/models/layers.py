"""Shared layers on torch (port of ``repro/models/layers.py``), the
single-token decode path ``attn_decode`` included.

Conventions follow the reference: weights are stored ``(in, out)``, stacked
layer leaves carry a leading layer dim, products come back in fp32, and
results are cast to the activation dtype where the reference casts.

Tensor parallelism (the ``model`` mesh axis): parameters may be DTensors
(``dist.sharding``), and the layers then run under DTensor's sharding
propagation (``dist.tp.model_context``). Two layers take the tensors'
shards by hand: ``embedding`` looks up a vocab-sharded table with the
vocab-parallel :class:`VocabParallelEmbedding` (DTensor's own lookup on a
``Shard(0)`` table fails in its backward), and ``cross_entropy`` gathers
vocab-sharded logits before it reduces them.

One difference in bf16: the reference keeps the fp32 accumulator of a
bf16 product (``preferred_element_type``); here the projection products
run in the working dtype and are rounded to it before the fp32 cast. In
fp32 (what the parity tests run) the two agree.

Self-attention (``attn_apply``) takes one of two routes, chosen by its
input (``attn_route``). CUDA tensors in bf16 at a head width the port's
flash kernels are built for, with no sliding window, run the Hopper flash
kernels (``kernels.flash_attention_bwd.flash_attention_train``): bf16
products with fp32 sums, P rounded to bf16 before P V as the reference
rounds it, and in the backward dS rounded to bf16 before the dQ and dK
products; the forward saves q, k, v, o and the log-sum-exp rows, never a
score tensor; fake CUDA tensors (the dry run's) take this route too.
Everything else (fp32, the CPU, other head widths, a sliding window)
runs ``blockwise_attention``, whose scores and softmax-weighted values
are computed in fp32 outright, one query block at a time; so do
cross-attention and the decode step.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.dist import tp
from repro_torch.dist.sharding import contiguous_stride
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.flash_attention_bwd import flash_attention_train

F32 = torch.float32


# --------------------------------------------------------------------------- init
# Initialisers draw on the CPU from the generator ``gen``; the model's
# ``init`` moves the finished tree to its device.
def dense_init(gen, shape, dtype, scale: float | None = None):
    """Normal(0, 1/sqrt(d_in)) weights of ``shape`` (..., d_in, d_out)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    w = torch.randn(tuple(shape), generator=gen, dtype=F32)
    return (w * scale).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype):
    w = torch.randn((vocab, d), generator=gen, dtype=F32)
    return (w * 0.02).to(dtype)


def _mm(eq: str, x, w):
    """Product in the operands' promoted dtype (as ``jnp.einsum`` promotes
    mixed operands: fp32 x bf16 runs in fp32), returned in fp32. Under the
    model axis a product over a split dim is summed at once in that dtype,
    and so is ``x``'s gradient in the backward (``tp.reduce_pending``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    x = tp.reduce_grad(x)
    return tp.reduce_pending(torch.einsum(eq, x.to(dt), w.to(dt))).to(F32)


# --------------------------------------------------------------------------- embedding
class VocabParallelEmbedding(torch.autograd.Function):
    """Lookup in a table whose rows are split over a process group.

    Each process holds rows ``[lo, lo + rows)``; it looks up the tokens it
    owns, zero-fills the others and sums the result over ``group``, so
    every process gets the whole lookup. The backward scatters the
    gradient into the owned rows only (``embedding_dense_backward``, the
    same deterministic sum as ``F.embedding``'s backward; at one process
    the two agree bit for bit)."""

    @staticmethod
    def forward(ctx, tokens, table, lo: int, group):
        rows = table.shape[0]
        ids = tokens - lo
        own = (ids >= 0) & (ids < rows)
        ids = torch.where(own, ids, torch.zeros_like(ids))
        out = F.embedding(ids, table).masked_fill(~own[..., None], 0)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        ctx.save_for_backward(ids, own)
        ctx.rows = rows
        return out

    @staticmethod
    def backward(ctx, grad):
        ids, own = ctx.saved_tensors
        grad = grad.masked_fill(~own[..., None], 0)
        table_grad = torch.ops.aten.embedding_dense_backward(
            grad.contiguous(), ids, ctx.rows, -1, False)
        return None, table_grad, None, None


def embedding(tokens, table):
    """``F.embedding(tokens, table)``; for a DTensor table the lookup runs
    on the local shards and comes back a DTensor placed as ``tokens``
    (replicated over ``model``): a table split over ``model`` on its rows
    through :class:`VocabParallelEmbedding`, any other split (FSDP over
    ``data``) gathered first."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    keep = tuple(p if n == "model" else Replicate()
                 for n, p in zip(names, table.placements))
    if keep != tuple(table.placements):
        table = table.redistribute(mesh, keep)
    if isinstance(tokens, DTensor):
        tok, tok_pl = tokens.to_local(), tokens.placements
    else:
        tok, tok_pl = tokens, (Replicate(),) * len(names)
    # a process that looks up only its batch rows holds a partial sum of
    # the table's gradient over the batch split
    local = table.to_local(grad_placements=tuple(
        Partial() if t == Shard(0) else p for p, t in zip(keep, tok_pl)))
    if "model" in names and keep[names.index("model")] == Shard(0):
        out = VocabParallelEmbedding.apply(
            tok, local, mesh.get_local_rank("model") * local.shape[0],
            mesh.get_group("model"))
    else:
        out = F.embedding(tok, local)
    shape = tuple(tokens.shape) + (table.shape[-1],)
    return DTensor.from_local(out, mesh, tok_pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


# --------------------------------------------------------------------------- norms
def rms_norm(x, weight, eps: float = 1e-5):
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.to(F32)).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    x32 = x.to(F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.to(F32) + bias.to(F32)).to(x.dtype)


# --------------------------------------------------------------------------- rope
def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, T, H, Dh); positions: (B, T)."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=F32, device=x.device) / dh))
    ang = positions[..., :, None].to(F32) * inv
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(T: int, d: int, dtype=F32, device=None):
    """(T, d) sine/cosine positions: sin on even columns, cos on odd."""
    pos = torch.arange(T, dtype=F32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=F32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((T, d), dtype=F32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


# --------------------------------------------------------------------------- mlp
def mlp_init(gen, n: int, d_model: int, d_ff: int, dtype, gated: bool = True,
             bias: bool = False):
    p = {"up": dense_init(gen, (n, d_model, d_ff), dtype),
         "down": dense_init(gen, (n, d_ff, d_model), dtype)}
    if gated:
        p["gate"] = dense_init(gen, (n, d_model, d_ff), dtype)
    if bias:
        p["up_bias"] = torch.zeros((n, d_ff), dtype=dtype)
        p["down_bias"] = torch.zeros((n, d_model), dtype=dtype)
    return p


def mlp_apply(p, x, act: str = "silu"):
    """x: (..., d_model) -> (..., d_model)."""
    up = _mm("...d,df->...f", x, p["up"])
    if "up_bias" in p:
        up = up + p["up_bias"].to(F32)
    if "gate" in p:
        gate = _mm("...d,df->...f", x, p["gate"])
        h = (F.silu(gate) if act == "silu"
             else F.gelu(gate, approximate="tanh")) * up
    else:
        h = F.gelu(up, approximate="tanh") if act == "gelu" else F.silu(up)
    h = h.to(x.dtype)
    out = _mm("...f,fd->...d", h, p["down"])
    if "down_bias" in p:
        out = out + p["down_bias"].to(F32)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- attention
def attn_init(gen, n: int, d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, dtype, qkv_bias: bool = False,
              qk_norm: bool = False):
    p = {
        "wq": dense_init(gen, (n, d_model, num_heads * head_dim), dtype),
        "wk": dense_init(gen, (n, d_model, num_kv_heads * head_dim), dtype),
        "wv": dense_init(gen, (n, d_model, num_kv_heads * head_dim), dtype),
        "wo": dense_init(gen, (n, num_heads * head_dim, d_model), dtype),
    }
    z = lambda *s: torch.zeros((n,) + s, dtype=dtype)
    if qkv_bias:
        p["q_bias"] = z(num_heads * head_dim)
        p["k_bias"] = z(num_kv_heads * head_dim)
        p["v_bias"] = z(num_kv_heads * head_dim)
    if qk_norm:
        p["q_norm_scale"] = torch.ones((n, head_dim), dtype=dtype)
        p["k_norm_scale"] = torch.ones((n, head_dim), dtype=dtype)
    return p


def _project_qkv(p, x, num_heads, num_kv_heads, head_dim, positions,
                 rope_theta, use_rope, norm_eps):
    B, T, _ = x.shape
    q = _mm("btd,de->bte", x, p["wq"])
    k = _mm("btd,de->bte", x, p["wk"])
    v = _mm("btd,de->bte", x, p["wv"])
    if "q_bias" in p:
        q = q + p["q_bias"].to(F32)
        k = k + p["k_bias"].to(F32)
        v = v + p["v_bias"].to(F32)
    heads = tp.gather_unless_divides
    q = heads(q, -1, num_heads).reshape(B, T, num_heads, head_dim)
    k = heads(k, -1, num_kv_heads).reshape(B, T, num_kv_heads, head_dim)
    v = heads(v, -1, num_kv_heads).reshape(
        B, T, num_kv_heads, head_dim).to(x.dtype)
    if "q_norm_scale" in p:
        q = rms_norm(q, p["q_norm_scale"], norm_eps)
        k = rms_norm(k, p["k_norm_scale"], norm_eps)
    if use_rope:
        q = apply_rope(q.to(x.dtype), positions, rope_theta)
        k = apply_rope(k.to(x.dtype), positions, rope_theta)
    return q.to(x.dtype), k.to(x.dtype), v


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        block_q: int = 512):
    """Causal GQA attention, one query block at a time.

    q: (B, Tq, H, Dh); k, v: (B, Tk, Hkv, Dh), H a multiple of Hkv. Masked
    scores are -1e30; softmax in fp32; never more than (block_q x Tk)
    scores live at once. (The reference pads Tq to a multiple of block_q;
    rows are independent, so the short last block here gives the same
    values.)
    """
    B, Tq, H, Dh = q.shape
    _, Tk, Hkv, _ = k.shape
    rep = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    k32, v32 = k.to(F32), v.to(F32)
    k_pos = torch.arange(Tk, device=q.device)
    outs = []
    for start in range(0, Tq, block_q):
        qi = q[:, start:start + block_q]
        bq = qi.shape[1]
        q_pos = start + torch.arange(bq, device=q.device)
        qh = qi.reshape(B, bq, Hkv, rep, Dh).to(F32)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qh, k32) * scale
        mask = torch.ones((bq, Tk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = s.masked_fill(~mask, -1e30)
        p = torch.softmax(s, dim=-1).to(v.dtype).to(F32)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p, v32)
        outs.append(o.reshape(B, bq, H, Dh).to(v.dtype))
    return torch.cat(outs, dim=1)


def attn_route(q, k, v, window: int = 0) -> str:
    """``"flash"`` where the flash kernels compute this attention: q, k and
    v CUDA tensors in bf16, a head width in ``flash_attention.HEAD_DIMS``,
    and no sliding window; else ``"blockwise"``. Fake CUDA tensors (the
    dry run's) take the same route: the flash op gives them its outputs'
    shapes and FLOP count without a kernel."""
    if (window == 0 and q.is_cuda and q.dtype == torch.bfloat16
            and k.dtype == v.dtype == q.dtype and q.shape[-1] in HEAD_DIMS):
        return "flash"
    return "blockwise"


def attn_apply(p, x, *, num_heads: int, num_kv_heads: int, head_dim: int,
               causal: bool = True, positions=None, rope_theta: float = 1e4,
               use_rope: bool = True, window: int = 0, norm_eps: float = 1e-5,
               block_q: int = 512):
    """Full-sequence (training) GQA attention, on the route
    :func:`attn_route` picks for the (local) q, k and v; each call is
    counted in ``attn_apply.calls_by_route``."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device).expand(B, T)
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                           positions, rope_theta, use_rope, norm_eps)
    wrap = None
    if isinstance(q, DTensor):
        # attention is per batch row and head: it runs on the local shards
        q, k, v, wrap = tp.local_heads(q, k, v, num_kv_heads)
    route = attn_route(q, k, v, window)
    attn_apply.calls_by_route[route] += 1
    if route == "flash":
        o = flash_attention_train(q, k, v, causal)
    else:
        o = blockwise_attention(q, k, v, causal=causal, window=window,
                                block_q=block_q)
    o = o.reshape(o.shape[0], T, -1)
    if wrap is not None:
        o = wrap(o, (B, T, num_heads * head_dim))
    return _mm("bte,ed->btd", o, p["wo"]).to(x.dtype)


#: ``attn_apply`` calls by route (under remat a block's call runs again in
#: the backward, and counts again).
attn_apply.calls_by_route = {"flash": 0, "blockwise": 0}


def _bmm_f32(a, b):
    """Batched product of two same-dtype operands, returned in fp32 with
    fp32 accumulation (the reference's ``preferred_element_type=F32``): on
    the card cuBLAS writes the fp32 result of bf16 operands directly
    (``out_dtype``), so no fp32 copy of an operand is made; the CPU has no
    such product, and its operands are cast to fp32 there."""
    if a.dtype == F32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=F32)
    return torch.bmm(a.to(F32), b.to(F32))


def attn_decode(p, x, cache_k, cache_v, cache_len, *, num_heads: int,
                num_kv_heads: int, head_dim: int, rope_theta: float = 1e4,
                use_rope: bool = True, window: int = 0,
                norm_eps: float = 1e-5):
    """Single-token GQA decode against a KV cache.

    x: (B, 1, d); cache_k/v: (B, C, Hkv, Dh), C the longest context (a full
    cache) or the window (``window > 0``: a ring buffer); cache_len: a 0-d
    int tensor, the tokens already in the cache and so the new token's
    position. The new K/V row is written INTO ``cache_k``/``cache_v`` at
    slot ``cache_len`` (``cache_len % C`` in a ring), so the returned
    caches are the given tensors. Past C a full cache's slot stays at C - 1,
    as ``jax.lax.dynamic_update_slice`` clamps its start. Nothing here
    reads a value back to the host.

    Scores and values are products of cache-dtype operands accumulated and
    returned in fp32 (``_bmm_f32``), as the reference's; scores are masked
    with -1e30 and softmaxed in fp32, and P is cast to the cache's dtype
    before the value product. Each product reads the cache through one
    copy in its own layout (batch and kv-head dims together), in the
    cache's dtype. Returns (out (B, 1, d), cache_k, cache_v).
    """
    B = x.shape[0]
    C = cache_k.shape[1]
    positions = cache_len.reshape(1, 1).expand(B, 1)
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                           positions, rope_theta, use_rope, norm_eps)
    wrap = None
    if isinstance(q, DTensor):
        # under the model axis the cache holds this process's batch rows
        # and its split of the kv heads (``dist.sharding.cache_pspecs``'s:
        # K/V leaves named k and v) or all of them, and attention runs on
        # local tensors split as the cache is (its rows too, where the
        # projections gathered a data split)
        if cache_k.shape[0] < B:
            q, k, v = (tp.split_batch(t) for t in (q, k, v))
        q, k, v, wrap = tp.local_heads(
            q, k, v, num_kv_heads,
            split_heads=cache_k.shape[2] < num_kv_heads)
    slot = cache_len % C if window > 0 else torch.clamp(cache_len, max=C - 1)
    idx = slot.reshape(1).long()
    cache_k.index_copy_(1, idx, k.to(cache_k.dtype))
    cache_v.index_copy_(1, idx, v.to(cache_v.dtype))

    b, heads, kv_heads = q.shape[0], q.shape[2], k.shape[2]
    rep = heads // kv_heads
    G = b * kv_heads
    qh = q.reshape(G, rep, head_dim).to(cache_k.dtype)
    kt = cache_k.permute(0, 2, 3, 1).reshape(G, head_dim, C)
    s = _bmm_f32(qh, kt) / math.sqrt(head_dim)                  # (G, rep, C)
    k_idx = torch.arange(C, device=x.device)
    if window > 0:
        # ring buffer: valid slots are the last min(cache_len + 1, C) writes
        age = (slot - k_idx) % C
        valid = age <= torch.clamp(cache_len, max=C - 1)
    else:
        valid = k_idx <= cache_len
    s = s.masked_fill(~valid, -1e30)
    pattn = torch.softmax(s, dim=-1).to(cache_v.dtype)
    vt = cache_v.permute(0, 2, 1, 3).reshape(G, C, head_dim)
    o = _bmm_f32(pattn, vt)                                      # (G, rep, Dh)
    o = o.reshape(b, 1, heads * head_dim).to(x.dtype)
    if wrap is not None:
        o = wrap(o, (B, 1, num_heads * head_dim))
    return _mm("bte,ed->btd", o, p["wo"]).to(x.dtype), cache_k, cache_v


def cross_attn_apply(p, x, enc_k, enc_v, *, num_heads: int,
                     num_kv_heads: int, head_dim: int):
    """Cross-attention with precomputed encoder K/V (the Whisper decoder).
    The output comes back in ``x``'s dtype; the attention itself runs in
    the encoder K/V's (fp32 under the fp32 encoder stream)."""
    B, T, _ = x.shape
    q = _mm("btd,de->bte", x, p["wq"])
    q = tp.gather_unless_divides(q, -1, num_heads)
    q = q.reshape(B, T, num_heads, head_dim).to(x.dtype)
    k, v, wrap = enc_k, enc_v, None
    if isinstance(q, DTensor):
        # per batch row and head, as attn_apply: on the local shards; a
        # decode cache's plain K/V hold every head of this process's rows
        k, v = (t if isinstance(t, DTensor) else DTensor.from_local(
            t, q.device_mesh, (Replicate(),) * q.device_mesh.ndim,
            run_check=False) for t in (k, v))
        q, k, v, wrap = tp.local_heads(q, k, v, num_kv_heads)
    o = blockwise_attention(q, k, v, causal=False,
                            block_q=min(512, max(T, 8)))
    o = o.reshape(o.shape[0], T, -1)
    if wrap is not None:
        o = wrap(o, (B, T, num_heads * head_dim))
    return _mm("bte,ed->btd", o, p["wo"]).to(x.dtype)


def cross_kv(p, enc_out, *, num_kv_heads: int, head_dim: int):
    """Encoder memory -> (K, V), each (B, S, Hkv, Dh) in its dtype."""
    B, S, _ = enc_out.shape
    k = tp.gather_unless_divides(_mm("bsd,de->bse", enc_out, p["wk"]), -1,
                                 num_kv_heads)
    v = tp.gather_unless_divides(_mm("bsd,de->bse", enc_out, p["wv"]), -1,
                                 num_kv_heads)
    return (k.reshape(B, S, num_kv_heads, head_dim).to(enc_out.dtype),
            v.reshape(B, S, num_kv_heads, head_dim).to(enc_out.dtype))


# --------------------------------------------------------------------------- stacks
def apply_units(fn, units, x, cfg):
    """``x = fn(unit_i, x, cfg)`` over a stacked tree's units, each under
    ``torch.utils.checkpoint`` when ``cfg.remat``; the carry ``x`` may be a
    tensor or a tuple of them. The units come from
    ``unbind``, whose backward stacks their gradients once (an index per
    unit would write each into a zero-filled copy of the stack). A stack
    split on its layer dim (FSDP under mode ``auto``) is gathered first."""
    for xs in zip(*(tp.whole_dim0(a).unbind(0) for a in tree.leaves(units))):
        u = tree.unflatten(units, xs)
        if cfg.remat:
            x = checkpoint(fn, u, x, cfg, use_reentrant=False)
        else:
            x = fn(u, x, cfg)
    return x


# --------------------------------------------------------------------------- head
def lm_logits(x, embed_or_head, tie: bool):
    """Final projection to vocab (fp32); tied uses the embedding transposed."""
    if tie:
        return _mm("btd,vd->btv", x, embed_or_head)
    return _mm("btd,dv->btv", x, embed_or_head)


def cross_entropy(logits, labels, mask=None):
    """Mean next-token CE in nats; logits (B,T,V) fp32, labels (B,T) int64.

    DTensor logits (tensor parallelism) are gathered over every mesh dim
    but the labels' batch split over the data axes; each process then
    takes the CE of its batch rows, and the sums are added over the
    split."""
    if isinstance(logits, DTensor):
        return _cross_entropy_dtensor(logits, labels, mask)
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _cross_entropy_dtensor(logits, labels, mask):
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    rows = tuple(Shard(0) if n in ("pod", "data") and isinstance(labels, DTensor)
                 and labels.placements[i] == Shard(0) else Replicate()
                 for i, n in enumerate(names))
    local = logits.redistribute(mesh, rows).to_local()
    plain = lambda t: t.to_local() if isinstance(t, DTensor) else t
    if Shard(0) not in rows:
        return cross_entropy(local, plain(labels), plain(mask))
    lse = torch.logsumexp(local.to(F32), dim=-1)
    nll = lse - torch.gather(local.to(F32), -1, plain(labels)[..., None])[..., 0]
    summed = tuple(Partial() if p == Shard(0) else Replicate() for p in rows)
    total = lambda t: DTensor.from_local(t, mesh, summed,
                                         run_check=False).full_tensor()
    if mask is not None:
        m = plain(mask)
        return total(torch.sum(nll * m)) / torch.clamp(
            total(torch.sum(m).detach()), min=1.0)
    return total(torch.sum(nll)) / (labels.shape[0] * labels.shape[1])
