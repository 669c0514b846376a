"""Model registry: ModelConfig + build_model() (port of ``repro/models/model.py``).

``build_model(cfg)`` returns a :class:`Model` bundle:

  * ``init(seed, device) -> params``   nested dict/list tree of tensors
  * ``loss_fn(params, batch) -> (loss, metrics)``
  * ``forward(params, batch) -> logits``

``batch`` holds ``tokens``/``labels`` (B, T) int64 tensors. Only the dense
family is ported; the others are ROADMAP Queue 1 item 9. Serving
(``init_cache``/``decode_step``) is Queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree

__all__ = ["ModelConfig", "Model", "build_model", "param_count",
           "near_even_split"]


def near_even_split(total: int, parts: int) -> list[int]:
    """Split ``total`` units into ``parts`` near-even contiguous groups."""
    base, extra = divmod(total, max(1, parts))
    return [base + (1 if i < extra else 0) for i in range(max(1, parts))]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense (ported) | moe | xlstm | zamba | whisper | vlm
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


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet "
            "(ROADMAP Queue 1 item 9); the port has the dense family")
    from . import transformer
    return transformer.build(cfg)


def param_count(params: Any) -> int:
    return sum(int(l.numel()) for l in tree.leaves(params))
