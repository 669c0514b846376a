"""Per-family stage adapters: the pipeline-partition contract.

Port of ``repro/pipeline/adapters.py`` (the base class and the dense, VLM
and MoE adapters). Every family that can run the pipeline executor registers a
:class:`StageAdapter` subclass here. The adapter owns:

  * the **support check** (``check``): a family-specific reason string when
    a config cannot be pipelined;
  * the **layer -> stage assignment** (``unit_counts``): how many stacked
    units each stage owns. Counts may be ragged, so ``partition_params``
    zero-pads every stage's stacks to the widest stage and the compute
    skips the dead (padded) units of each stage;
  * the **stage-stacked / shared split** (``partition_params`` /
    ``merge_params``): stacked leaves lead with (S, Lmax, ...); the rest
    (embeddings, head, norms) is shared by every stage;
  * the **compute** (``embed`` / ``blocks_segment`` / ``head_loss``):
    ``blocks_segment`` runs a span ``[lo, hi)`` of one stage's units and
    returns ``(boundary_out, aux_loss)``; chaining segments over any
    partition of ``[0, num_units)`` reproduces ``blocks``;
  * the **stash and boundary specs** (``stash_spec`` / ``boundary_spec``):
    shape and dtype of one stashed inter-unit carry and of one boundary
    activation (the same for the dense, VLM and MoE families).

Stage-assignable parameters live under ``params['stages'][i]``, so the
local <-> global leaf-path mapping is one regex shared by every family.
The xLSTM, Zamba2 and Whisper adapters come with their models (ROADMAP
Queue 1 items 9d-9f); ``supported_reason`` names them.
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.models.model import Model, ModelConfig

__all__ = [
    "StageAdapter",
    "TensorSpec",
    "register_adapter",
    "adapter_families",
    "supported_reason",
    "make_adapter",
    "global_leaf_path",
    "local_leaf_path",
]

_STAGE_PREFIX = re.compile(r"^\['stages'\]\[(\d+)\]")

F32 = torch.float32

# families with a stage adapter in the reference, not ported yet
_LATER_FAMILIES = ("xlstm", "zamba", "whisper")


class TensorSpec(NamedTuple):
    """Shape and dtype of one activation (what a pipe send moves)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def global_leaf_path(stage: int, local_path: str) -> str:
    """Stage-local keystr -> the flat-layout keystr the plans use."""
    return f"['stages'][{stage}]{local_path}"


def local_leaf_path(path: str) -> tuple[int, str] | None:
    """Flat-layout keystr -> (stage, stage-local keystr); None if shared."""
    m = _STAGE_PREFIX.match(path)
    if m is None:
        return None
    return int(m.group(1)), path[m.end():]


# -------------------------------------------------------------------- registry
_REGISTRY: dict[str, type["StageAdapter"]] = {}


def register_adapter(*families: str):
    def deco(cls):
        for f in families:
            _REGISTRY[f] = cls
        cls.family = families[0]
        return cls
    return deco


def adapter_families() -> list[str]:
    return sorted(_REGISTRY)


def supported_reason(cfg: ModelConfig, num_stages: int) -> str | None:
    """None if (family, config) can run the pipeline executor, else why not
    (the family's own adapter says what is missing)."""
    if num_stages <= 0:
        return f"num_stages={num_stages} must be >= 1"
    cls = _REGISTRY.get(cfg.family)
    if cls is None:
        reason = (f"family {cfg.family!r} has no stage adapter "
                  f"(registered: {adapter_families()})")
        if cfg.family in _LATER_FAMILIES:
            reason += ("; its adapter comes with the family's port "
                       "(ROADMAP Queue 1 item 9)")
        return reason
    return cls.check(cfg, num_stages)


def make_adapter(model: Model, num_stages: int,
                 remat: bool | None = None) -> "StageAdapter":
    reason = supported_reason(model.config, num_stages)
    if reason is not None:
        raise ValueError(f"pipeline partition unsupported: {reason}")
    return _REGISTRY[model.config.family](model, num_stages, remat)


# ------------------------------------------------------------------ base class
class StageAdapter:
    """Family-agnostic machinery; subclasses fill in the family contract.

    Built per (model, num_stages) by :func:`make_adapter`. The compute
    methods take a concrete stage index ``s``: each stage's program knows
    which stage it runs, so dead units are skipped on the host.
    """

    family = ""

    def __init__(self, model: Model, num_stages: int,
                 remat: bool | None = None) -> None:
        self.model = model
        self.cfg = model.config
        self.num_stages = num_stages
        self.remat = self.cfg.remat if remat is None else remat
        self._counts = {k: tuple(v) for k, v in self.unit_counts().items()}
        # (S, Lmax) live-unit masks, None for uniform (non-ragged) stacks
        self._masks: dict[str, np.ndarray | None] = {}
        for key, per in self._counts.items():
            lmax = max(per)
            if all(c == lmax for c in per):
                self._masks[key] = None
            else:
                self._masks[key] = (np.arange(lmax)[None, :]
                                    < np.asarray(per)[:, None])

    # ---- family contract (override) ------------------------------------
    @classmethod
    def check(cls, cfg: ModelConfig, num_stages: int) -> str | None:
        raise NotImplementedError

    def unit_counts(self) -> dict[str, list[int]]:
        """stack-key -> stacked units per stage (pure function of cfg)."""
        raise NotImplementedError

    def embed(self, shared: Any, mb: dict) -> torch.Tensor:
        """Stage-0 boundary input from one microbatch."""
        raise NotImplementedError

    def blocks_segment(self, stage_tree: Any, shared: Any, boundary: Any,
                       s: int, lo: int, hi: int) -> tuple[Any, torch.Tensor]:
        """Units ``[lo, hi)`` of stage ``s``: boundary -> (boundary, aux)."""
        raise NotImplementedError

    def blocks(self, stage_tree: Any, shared: Any, boundary: Any,
               s: int) -> tuple[Any, torch.Tensor]:
        """One stage's full compute: boundary -> (boundary, aux loss)."""
        return self.blocks_segment(stage_tree, shared, boundary, s,
                                   0, self.num_units())

    def num_units(self) -> int:
        """Stash-segmentable units per stage (the widest stage's count)."""
        assert len(self._counts) == 1, "multi-stack family must override"
        (per,) = self._counts.values()
        return max(per)

    def stash_spec(self, mb: dict) -> TensorSpec:
        """Spec of ONE stashed inter-unit carry: the boundary activation
        for every family whose units carry nothing else."""
        return self.boundary_spec(mb)

    def head_loss(self, shared: Any, boundary: Any, mb: dict) -> torch.Tensor:
        """Last-stage loss from the final boundary."""
        raise NotImplementedError

    def boundary_spec(self, mb: dict) -> TensorSpec:
        """Spec of one boundary activation: one (b, T, d_model) tensor."""
        b, t = mb["tokens"].shape
        return TensorSpec((b, t, self.cfg.d_model), self.cfg.torch_dtype)

    # ---- path mapping (shared ['stages'][i] convention) -----------------
    local_leaf_path = staticmethod(local_leaf_path)
    global_leaf_path = staticmethod(global_leaf_path)

    # ---- generic stage-stacked layout -----------------------------------
    def stage_flags(self, key: str, s: int) -> np.ndarray | None:
        """Stage s's (Lmax,) live-unit mask for a stack, None when uniform."""
        m = self._masks[key]
        return None if m is None else m[s]

    def partition_params(self, params: Any) -> tuple[Any, Any]:
        """Split a flat param tree into (stage_stacked, shared).

        ``stage_stacked`` holds every ``['stages'][i]`` stack with a new
        leading stage dim (S, Lmax, ...), zero-padded where a stage owns
        fewer units than the widest; ``shared`` is the rest, same keys.
        """
        stages = params["stages"]
        if len(stages) != self.num_stages:
            raise ValueError(f"param layout has {len(stages)} stages, "
                             f"expected {self.num_stages}")
        stacked = {}
        for key, per in self._counts.items():
            lmax = max(per)
            ref = next(st[key] for st, c in zip(stages, per) if c)

            def one(st, c):
                if c == 0:
                    return tree.tree_map(
                        lambda a: a.new_zeros((lmax,) + tuple(a.shape[1:])),
                        ref)
                sub = st[key]
                lead = tree.leaves(sub)[0].shape[0]
                if lead != c:
                    raise ValueError(
                        f"stack {key!r}: param leading dim {lead} != "
                        f"adapter count {c} (layout/config mismatch)")
                if c == lmax:
                    return sub
                return tree.tree_map(
                    lambda a: torch.cat(
                        [a, a.new_zeros((lmax - c,) + tuple(a.shape[1:]))]),
                    sub)

            stacked[key] = tree.tree_map(
                lambda *xs: torch.stack(xs),
                *[one(st, c) for st, c in zip(stages, per)])
        shared = {k: v for k, v in params.items() if k != "stages"}
        return stacked, shared

    def merge_params(self, stage_stacked: Any, shared: Any) -> Any:
        """Inverse of :meth:`partition_params`: back to the flat layout."""
        stages = []
        for s in range(self.num_stages):
            st = {}
            for key, per in self._counts.items():
                c = per[s]
                if c == 0:
                    continue
                st[key] = tree.tree_map(lambda a: a[s, :c],
                                        stage_stacked[key])
            stages.append(st)
        params = dict(shared)
        params["stages"] = stages
        return params

    @staticmethod
    def split_units(stage_tree: Any) -> dict[str, list]:
        """One stage's stacks (leaves (Lmax, ...)) -> per-unit trees, the
        form ``blocks_segment`` takes (each unit's gradient its own
        tensor)."""
        return {key: [tree.tree_map(lambda a, i=i: a[i], sub)
                      for i in range(tree.leaves(sub)[0].shape[0])]
                for key, sub in stage_tree.items()}

    # ---- unit loop -------------------------------------------------------
    def _run_units(self, body, carry, units: list, flags):
        """Apply ``body`` over a stage's units in order; a dead (padded)
        unit leaves the carry unchanged (skipped: its flag is host data).
        With ``remat``, each unit recomputes its activations in the
        backward (only where autograd records)."""
        for i, unit in enumerate(units):
            if flags is not None and not flags[i]:
                continue
            if self.remat and torch.is_grad_enabled():
                carry = checkpoint(body, carry, unit, use_reentrant=False)
            else:
                carry = body(carry, unit)
        return carry


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, t = x.shape[0], x.shape[1]
    return torch.arange(t, device=x.device).expand(b, t)


# --------------------------------------------------------------------- dense
@register_adapter("dense")
class DenseAdapter(StageAdapter):
    """Decoder-only transformer: stacked blocks, token embed + head.

    ``stage_tree["blocks"]`` is a list of per-unit block trees (one per
    unit slot of the stage, padded slots included: ``split_units``).
    """

    @classmethod
    def check(cls, cfg: ModelConfig, num_stages: int) -> str | None:
        if cfg.num_stages != num_stages:
            return (f"model was built with num_stages={cfg.num_stages}, "
                    f"pipeline wants {num_stages}; rebuild the model config")
        if cfg.num_layers < num_stages:
            return (f"num_layers={cfg.num_layers} < num_stages={num_stages}:"
                    " at least one block per stage is required")
        return None

    def unit_counts(self):
        return {"blocks": self.cfg.stage_sizes()}

    def embed(self, shared, mb):
        from repro_torch.models import transformer as T
        return T.embed_tokens(shared, mb["tokens"], self.cfg)

    def blocks_segment(self, stage_tree, shared, x, s, lo, hi):
        from repro_torch.models import transformer as T
        cfg = self.cfg
        pos = _positions(x)

        def body(h, bp):
            return T._block_apply(bp, h, cfg, pos, cfg.sliding_window)
        flags = self.stage_flags("blocks", s)
        y = self._run_units(body, x, stage_tree["blocks"][lo:hi],
                            None if flags is None else flags[lo:hi])
        return y, torch.zeros((), dtype=F32, device=x.device)

    def head_loss(self, shared, y, mb):
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        logits = T.final_logits(shared, y, self.cfg)
        return L.cross_entropy(logits, mb["labels"], mb.get("mask"))


# ----------------------------------------------------------------------- vlm
@register_adapter("vlm")
class VLMAdapter(DenseAdapter):
    """Dense decoder over a [patches ; tokens] prefix; loss on text only.

    The boundary is (b, P + T, d_model) in the dtype the embed produces:
    the fp32 stub patches promote the stream (``models/vlm.py``)."""

    def boundary_spec(self, mb):
        b, t = mb["tokens"].shape
        p = mb["patches"].shape[1]
        dt = torch.promote_types(mb["patches"].dtype, self.cfg.torch_dtype)
        return TensorSpec((b, p + t, self.cfg.d_model), dt)

    def embed(self, shared, mb):
        from repro_torch.models import vlm as V
        return V._embed_multimodal(shared, mb["patches"], mb["tokens"],
                                   self.cfg)

    def head_loss(self, shared, y, mb):
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        p = y.shape[1] - mb["tokens"].shape[1]
        logits = T.final_logits(shared, y, self.cfg)[:, p:]
        return L.cross_entropy(logits, mb["labels"], mb.get("mask"))


# ----------------------------------------------------------------------- moe
@register_adapter("moe")
class MoEAdapter(StageAdapter):
    """MoE decoder: experts and router live with their block's stage; the
    Switch load-balance aux loss is a per-segment contribution, scaled by
    ``router_aux_weight / num_layers`` (the flat forward's weight times
    its mean over layers), so the spans of a stage stay additive and the
    executor adds them into the loss."""

    @classmethod
    def check(cls, cfg: ModelConfig, num_stages: int) -> str | None:
        if cfg.num_stages != num_stages:
            return (f"model was built with num_stages={cfg.num_stages}, "
                    f"pipeline wants {num_stages}; rebuild the model config")
        if cfg.num_layers < num_stages:
            return (f"num_layers={cfg.num_layers} < num_stages={num_stages}:"
                    " at least one MoE block per stage is required")
        return None

    def unit_counts(self):
        return {"blocks": self.cfg.stage_sizes()}

    def embed(self, shared, mb):
        return shared["embed"]["tok"][mb["tokens"]]

    def blocks_segment(self, stage_tree, shared, x, s, lo, hi):
        from repro_torch.models import moe as M
        cfg = self.cfg
        pos = _positions(x)

        def body(carry, bp):
            h, aux = carry
            h, a = M._block_apply(bp, h, cfg, pos, cfg.sliding_window)
            return h, aux + a
        flags = self.stage_flags("blocks", s)
        y, aux = self._run_units(
            body, (x, torch.zeros((), dtype=F32, device=x.device)),
            stage_tree["blocks"][lo:hi],
            None if flags is None else flags[lo:hi])
        return y, aux * cfg.router_aux_weight / max(1, cfg.num_layers)

    def head_loss(self, shared, y, mb):
        from repro_torch.models import layers as L
        cfg = self.cfg
        x = L.rms_norm(y, shared["final_norm_scale"], cfg.norm_eps)
        logits = L.lm_logits(x, shared["lm_head"], tie=False)
        return L.cross_entropy(logits, mb["labels"], mb.get("mask"))
