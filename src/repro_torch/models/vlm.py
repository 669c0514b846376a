"""Phi-3-vision family (port of ``repro/models/vlm.py``): a phi3-mini text
decoder over stubbed patch embeddings.

The vision encoder is a stub: the batch provides ``patches`` (B,
num_patches, d_model), the projector's input. The model prepends a learned
projection of the patches to the token embeddings and runs the dense
causal decoder, patches first; the loss is on the text positions only.

The stub patches are fp32, and the projected patches keep their dtype, so
the concatenation with the token embeddings promotes: under
``dtype="bfloat16"`` the residual stream, and the logits, are fp32 with
bf16 weights, as in the reference (whose ``jnp.concatenate`` promotes the
same way). Decoding is the dense decoder's, on text tokens only: it
never sees a patch prefix, as in the reference, whose ``prefill_patches``
raises.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tree
from . import layers as L
from . import transformer as TF
from .model import Model, ModelConfig, register_family

F32 = torch.float32


@torch.no_grad()
def init(cfg: ModelConfig, seed: int, device) -> dict[str, Any]:
    """The dense decoder's parameters plus ``projector.w`` and ``.b``,
    drawn on the CPU (the projector from a generator seeded ``seed + 1``)."""
    params = TF._init_cpu(cfg, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    params["projector"] = {
        "w": L.dense_init(gen, (cfg.d_model, cfg.d_model), cfg.torch_dtype),
        "b": torch.zeros((cfg.d_model,), dtype=cfg.torch_dtype),
    }
    return tree.tree_map(lambda t: t.to(device), params)


def _embed_multimodal(params, patches, tokens, cfg: ModelConfig):
    """[projected patches ; token embeddings] -> (B, P+T, d), in the
    promoted dtype of the two."""
    proj = L._mm("bpd,de->bpe", patches, params["projector"]["w"])
    proj = (proj + params["projector"]["b"].to(F32)).to(patches.dtype)
    tok = L.embedding(tokens, params["embed"]["tok"])
    dt = torch.promote_types(proj.dtype, tok.dtype)
    return torch.cat([proj.to(dt), tok.to(dt)], dim=1)


def forward(params, batch, cfg: ModelConfig):
    """Returns logits over the TEXT positions only: (B, T, V)."""
    patches, tokens = batch["patches"], batch["tokens"]
    B, P, _ = patches.shape
    T = tokens.shape[1]
    x = _embed_multimodal(params, patches, tokens, cfg)
    positions = torch.arange(P + T, device=tokens.device).expand(B, P + T)
    for stage in params["stages"]:
        x = TF.apply_block_stack(stage["blocks"], x, cfg, positions,
                                 cfg.sliding_window)
    return TF.final_logits(params, x, cfg)[:, P:]


def loss_fn(params, batch, cfg: ModelConfig):
    logits = forward(params, batch, cfg)
    loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss}


def prefill_patches(params, cache, patches, cfg: ModelConfig):
    """Feeding the patch prefix through the decode path is not implemented,
    in the reference either."""
    raise NotImplementedError("use engine-level prefill via forward()")


@register_family("vlm")
def build(cfg: ModelConfig) -> Model:
    return Model(
        config=cfg,
        init=lambda seed, device: init(cfg, seed, device),
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        forward=lambda p, b: forward(p, b, cfg),
        init_cache=lambda bs, max_len=32768, *, device: TF.init_cache(
            cfg, bs, max_len, device),
        decode_step=lambda p, c, t: TF.decode_step(p, c, t, cfg),
    )
