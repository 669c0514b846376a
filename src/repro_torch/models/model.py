"""Model registry: ModelConfig + build_model() (port of ``repro/models/model.py``).

``build_model(cfg)`` returns a :class:`Model` bundle:

  * ``init(seed, device) -> params``   nested dict/list tree of tensors
  * ``loss_fn(params, batch) -> (loss, metrics)``
  * ``forward(params, batch) -> logits``
  * ``init_cache(batch_size, max_len=..., *, device) -> cache``  decode state
  * ``decode_step(params, cache, tokens) -> (logits, cache)``  ONE token:
    tokens (B,), logits (B, V) fp32; the cache's tensors are updated in
    place and returned (the cache passed in is consumed)

``batch`` holds ``tokens``/``labels`` (B, T) int64 tensors; the VLM family
adds ``patches`` (B, P, d_model), the stubbed vision frontend's output
(``data.pipeline.add_modality_stubs``) and the Whisper family ``frames``
(B, audio_frames, d_model), the stubbed audio frontend's. All six families
of the reference are ported (dense, MoE, VLM, xLSTM, Zamba2, Whisper),
each with its decode path; ``max_len`` defaults to the reference's (32768,
Whisper 448; xLSTM's state has none).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree

__all__ = ["ModelConfig", "Model", "build_model", "register_family",
           "param_count", "active_param_count", "near_even_split",
           "concat_stage_stacks"]


def near_even_split(total: int, parts: int) -> list[int]:
    """Split ``total`` units into ``parts`` near-even contiguous groups."""
    base, extra = divmod(total, max(1, parts))
    return [base + (1 if i < extra else 0) for i in range(max(1, parts))]


def concat_stage_stacks(stacks: list[Any]) -> Any:
    """Concatenate per-stage stacked subtrees back to one (L, ...) tree
    (the flat forwards' inverse of the ``['stages'][s]`` relayout)."""
    if len(stacks) == 1:
        return stacks[0]
    return tree.tree_map(lambda *xs: torch.cat(xs, dim=0), *stacks)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | xlstm | zamba | whisper | vlm
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0            # 0 -> d_model // num_heads
    num_stages: int = 1          # virtual pipeline stages (EDGC/DAC grouping)
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"            # silu (gated) | gelu (gated) | gelu_plain
    pos: str = "rope"            # rope | learned | none
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    sliding_window: int = 0      # 0 = full attention; >0 = window size
    max_position: int = 1 << 20
    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group: int = 1024        # GShard dispatch group size (perf knob)
    # ssm / hybrid
    ssm_state: int = 0
    conv_kernel: int = 4
    chunk: int = 128             # chunk size for linear-recurrence scan
    attn_every: int = 6          # zamba: shared attn block cadence
    slstm_every: int = 2         # xlstm: every k-th block is sLSTM
    # whisper
    encoder_layers: int = 0
    audio_frames: int = 1500     # encoder positions after the conv stub
    # vlm
    num_patches: int = 576       # prepended image patch embeddings
    dtype: str = "float32"       # param/activation dtype
    block_q: int = 512           # attention query-block size
    remat: bool = False          # checkpoint each block (recompute in bwd)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def stage_sizes(self) -> list[int]:
        """Split num_layers into num_stages near-even contiguous groups."""
        return near_even_split(self.num_layers, self.num_stages)


class Model(NamedTuple):
    config: ModelConfig
    init: Callable[..., Any]
    loss_fn: Callable[[Any, dict], tuple[torch.Tensor, dict]]
    forward: Callable[[Any, dict], torch.Tensor]
    init_cache: Callable[..., Any]
    decode_step: Callable[[Any, Any, torch.Tensor],
                          tuple[torch.Tensor, Any]]


_REGISTRY: dict[str, Callable[[ModelConfig], Model]] = {}


def register_family(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _REGISTRY:
        # import side-effect registration
        from . import encdec, hybrid, moe, ssm, transformer, vlm  # noqa: F401
    if cfg.family not in _REGISTRY:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return _REGISTRY[cfg.family](cfg)


def param_count(params: Any) -> int:
    return sum(int(l.numel()) for l in tree.leaves(params))


def active_param_count(cfg: ModelConfig, params: Any) -> int:
    """Active params per token (MoE: top-k of the expert population)."""
    total = param_count(params)
    if cfg.family != "moe" or cfg.num_experts == 0:
        return total
    expert_leaves = sum(int(l.numel()) for path, l in
                        tree.flatten_with_path(params) if "expert" in path)
    active_frac = cfg.experts_per_token / max(1, cfg.num_experts)
    return int(total - expert_leaves + expert_leaves * active_frac)
