"""Per-family stage adapters: the pipeline-partition contract.

Port of ``repro/pipeline/adapters.py``: the base class and the adapters of
all six families (dense, VLM, MoE, xLSTM, Zamba2, Whisper). Every family
that can run the pipeline executor registers a :class:`StageAdapter`
subclass here. The adapter owns:

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
    partition of ``[0, num_units)`` reproduces ``blocks``. A unit is a
    stacked element for most families (a block, an xLSTM pair); Zamba2's
    is a group slot and Whisper's enumerates the encoder half, then the
    decoder half (``unit_index`` maps a stacked element to its unit);
  * the **stash and boundary specs** (``stash_spec`` / ``boundary_spec``):
    shape and dtype of one stashed inter-unit carry and of one boundary
    activation: one :class:`TensorSpec`, or for Whisper a dict of two
    (``{"mem", "x"}``, the encoder memory and the decoder stream).

Stage-assignable parameters live under ``params['stages'][i]``, so the
local <-> global leaf-path mapping is one regex shared by every family.
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
    "boundary_leaves",
    "boundary_unflatten",
    "register_adapter",
    "adapter_families",
    "supported_reason",
    "make_adapter",
    "global_leaf_path",
    "local_leaf_path",
]

_STAGE_PREFIX = re.compile(r"^\['stages'\]\[(\d+)\]")

F32 = torch.float32


class TensorSpec(NamedTuple):
    """Shape and dtype of one activation (what a pipe send moves)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def boundary_leaves(b) -> list:
    """A boundary's tensors (or specs) in sorted-key order: one tensor, or
    the values of a dict of them."""
    if isinstance(b, dict):
        return [x for k in sorted(b) for x in boundary_leaves(b[k])]
    return [b]


def boundary_unflatten(like, xs: list):
    """The boundary shaped like ``like`` whose leaves are ``xs``."""
    it = iter(xs)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


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
        return (f"family {cfg.family!r} has no stage adapter "
                f"(registered: {adapter_families()})")
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

    def unit_index(self, key: str, s: int, i: int) -> int:
        """The unit of stage s that element i of stack ``key`` belongs to
        (-1 for a padded element no unit runs)."""
        return i

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


def _untied_head_loss(cfg: ModelConfig, shared, y, mb) -> torch.Tensor:
    """RMSNorm, the untied ``lm_head`` and the loss."""
    from repro_torch.models import layers as L
    x = L.rms_norm(y, shared["final_norm_scale"], cfg.norm_eps)
    logits = L.lm_logits(x, shared["lm_head"], tie=False)
    return L.cross_entropy(logits, mb["labels"], mb.get("mask"))


def _stages_reason(cfg: ModelConfig, num_stages: int) -> str | None:
    if cfg.num_stages != num_stages:
        return (f"model was built with num_stages={cfg.num_stages}, "
                f"pipeline wants {num_stages}; rebuild the model config")
    return None


# --------------------------------------------------------------------- dense
@register_adapter("dense")
class DenseAdapter(StageAdapter):
    """Decoder-only transformer: stacked blocks, token embed + head.

    ``stage_tree["blocks"]`` is a list of per-unit block trees (one per
    unit slot of the stage, padded slots included: ``split_units``).
    """

    @classmethod
    def check(cls, cfg: ModelConfig, num_stages: int) -> str | None:
        reason = _stages_reason(cfg, num_stages)
        if reason is None and cfg.num_layers < num_stages:
            reason = (f"num_layers={cfg.num_layers} < num_stages={num_stages}:"
                      " at least one block per stage is required")
        return reason

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
        reason = _stages_reason(cfg, num_stages)
        if reason is None and cfg.num_layers < num_stages:
            reason = (f"num_layers={cfg.num_layers} < num_stages={num_stages}:"
                      " at least one MoE block per stage is required")
        return reason

    def unit_counts(self):
        return {"blocks": self.cfg.stage_sizes()}

    def embed(self, shared, mb):
        from repro_torch.models import layers as L
        return L.embedding(mb["tokens"], shared["embed"]["tok"])

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
        return _untied_head_loss(self.cfg, shared, y, mb)


# --------------------------------------------------------------------- xlstm
@register_adapter("xlstm")
class XLSTMAdapter(StageAdapter):
    """xLSTM: the stage unit is one (mLSTM, sLSTM) pair; splitting a pair
    would separate the matrix-memory block from its recurrent partner."""

    @classmethod
    def check(cls, cfg: ModelConfig, num_stages: int) -> str | None:
        if cfg.num_layers % 2:
            return f"num_layers={cfg.num_layers} must be even (pair stacks)"
        reason = _stages_reason(cfg, num_stages)
        if reason is not None:
            return reason
        n_pairs = cfg.num_layers // 2
        if n_pairs < num_stages:
            return (f"{n_pairs} (mLSTM, sLSTM) pairs < num_stages="
                    f"{num_stages}: at least one pair per stage is required")
        return None

    def unit_counts(self):
        from repro_torch.models.ssm import xlstm_stage_sizes
        return {"pairs": xlstm_stage_sizes(self.cfg)}

    def embed(self, shared, mb):
        from repro_torch.models import layers as L
        return L.embedding(mb["tokens"], shared["embed"]["tok"])

    def blocks_segment(self, stage_tree, shared, x, s, lo, hi):
        from repro_torch.models import ssm
        cfg = self.cfg
        flags = self.stage_flags("pairs", s)
        y = self._run_units(lambda h, pair: ssm.pair_apply(pair, h, cfg), x,
                            stage_tree["pairs"][lo:hi],
                            None if flags is None else flags[lo:hi])
        return y, torch.zeros((), dtype=F32, device=x.device)

    def head_loss(self, shared, y, mb):
        return _untied_head_loss(self.cfg, shared, y, mb)


# --------------------------------------------------------------------- zamba
@register_adapter("zamba")
class ZambaAdapter(StageAdapter):
    """Hybrid Mamba2 + shared attention: stages take whole attention groups
    (a mamba run and its shared-attention site), so per-stage layer counts
    are ragged whenever ``num_layers`` does not tile over groups and
    stages. The shared block rides in ``shared`` (its gradients summed over
    the stages, like the embeddings').

    The unit is a GROUP SLOT: the stage's runs in order, each followed by
    the shared block. Each stage runs its own plan, so the group slots a
    stage lacks and the padded layers are skipped, where the reference
    runs them masked."""

    def __init__(self, model, num_stages, remat=None):
        super().__init__(model, num_stages, remat)
        from repro_torch.models.hybrid import stage_group_sizes
        self._plan = stage_group_sizes(self.cfg, num_stages)
        # stage s's layer i -> its group slot
        self._slot = [[g for g, sz in enumerate(sizes) for _ in range(sz)]
                      for sizes in self._plan]

    @classmethod
    def check(cls, cfg: ModelConfig, num_stages: int) -> str | None:
        from repro_torch.models.hybrid import _num_groups
        reason = _stages_reason(cfg, num_stages)
        if reason is not None:
            return reason
        g = _num_groups(cfg)
        if g < num_stages:
            return (f"{g} attention groups (attn_every={cfg.attn_every}) < "
                    f"num_stages={num_stages}: whole groups per stage is "
                    "the hybrid pipelining constraint")
        return None

    def unit_counts(self):
        from repro_torch.models.hybrid import stage_group_sizes
        plan = stage_group_sizes(self.cfg, self.num_stages)
        return {"mamba": [sum(sizes) for sizes in plan]}

    def num_units(self):
        return max(len(sizes) for sizes in self._plan)

    def unit_index(self, key, s, i):
        slots = self._slot[s]
        return slots[i] if i < len(slots) else -1

    def embed(self, shared, mb):
        from repro_torch.models import layers as L
        return L.embedding(mb["tokens"], shared["embed"]["tok"])

    def blocks_segment(self, stage_tree, shared, x, s, lo, hi):
        from repro_torch.models import hybrid, ssm
        cfg = self.cfg
        pos = _positions(x)
        sizes = self._plan[s]
        layers = stage_tree["mamba"]
        starts = np.cumsum([0] + sizes)

        def group(h, run):
            for mp in run:
                h = ssm.mamba2_apply(mp, h, cfg)
            return hybrid.shared_apply(shared["shared"], h, cfg, pos)
        runs = [layers[starts[g]:starts[g + 1]]
                for g in range(lo, min(hi, len(sizes)))]
        y = self._run_units(group, x, runs, None)
        return y, torch.zeros((), dtype=F32, device=x.device)

    def head_loss(self, shared, y, mb):
        return _untied_head_loss(self.cfg, shared, y, mb)


# ------------------------------------------------------------------- whisper
@register_adapter("whisper")
class EncDecAdapter(StageAdapter):
    """Encoder-decoder: encoder stages before decoder stages. The boundary
    carries two tensors: ``mem``, the running encoder hidden (the encoder
    output once it crosses into the decoder half, read by every decoder
    stage's cross-attention), and ``x``, the decoder hidden (the token
    embeddings, carried through the encoder half untouched). ``mem``'s
    cotangent accumulates through the decoder stages on the way back.

    The boundary has the dtypes the embed produces: ``mem`` the stub
    frames' (fp32), ``x`` the parameters'. (The reference declares both in
    the parameter dtype.)"""

    def __init__(self, model, num_stages, remat=None):
        super().__init__(model, num_stages, remat)
        self._num_enc_stages = sum(
            1 for c in self._counts["enc_blocks"] if c > 0)
        self._le = max(self._counts["enc_blocks"])

    @classmethod
    def check(cls, cfg: ModelConfig, num_stages: int) -> str | None:
        from repro_torch.models.encdec import stage_layout
        reason = _stages_reason(cfg, num_stages)
        if reason is not None:
            return reason
        le = cfg.encoder_layers or cfg.num_layers
        if num_stages > le + cfg.num_layers:
            return (f"num_stages={num_stages} > {le}+{cfg.num_layers} "
                    "enc+dec layers")
        layout = stage_layout(cfg, num_stages)
        if len(layout) != num_stages:
            return (f"enc/dec split yields {len(layout)} stages for "
                    f"num_stages={num_stages}")
        return None

    def unit_counts(self):
        from repro_torch.models.encdec import stage_layout
        layout = stage_layout(self.cfg, self.num_stages)
        return {"enc_blocks": [c["enc"] for c in layout],
                "dec_blocks": [c["dec"] for c in layout]}

    def boundary_spec(self, mb):
        b, t = mb["tokens"].shape
        a = mb["frames"].shape[1]
        d = self.cfg.d_model
        return {"mem": TensorSpec((b, a, d), mb["frames"].dtype),
                "x": TensorSpec((b, t, d), self.cfg.torch_dtype)}

    def embed(self, shared, mb):
        from repro_torch.models import encdec as E
        return {"mem": E.embed_frames(mb["frames"]),
                "x": E.embed_tokens(shared, mb["tokens"])}

    def num_units(self):
        # the encoder half's units first, then the decoder half's, in the
        # order a stage runs them
        return self._le + max(self._counts["dec_blocks"])

    def unit_index(self, key, s, i):
        return i if key == "enc_blocks" else self._le + i

    def blocks_segment(self, stage_tree, shared, bnd, s, lo, hi):
        from repro_torch.models import encdec as E
        cfg = self.cfg
        le = self._le
        mem, x = bnd["mem"], bnd["x"]
        elo, ehi = lo, min(hi, le)
        if ehi > elo:
            flags = self.stage_flags("enc_blocks", s)
            mem = self._run_units(
                lambda h, bp: E.enc_block_apply(bp, h, cfg), mem,
                stage_tree["enc_blocks"][elo:ehi],
                None if flags is None else flags[elo:ehi])
        # the encoder's output norm, once: on the last encoder stage, by
        # the segment that runs the last encoder unit
        if le and lo <= le - 1 < hi and s == self._num_enc_stages - 1:
            mem = E._ln(mem, shared, "enc_norm", cfg)
        dlo, dhi = max(lo - le, 0), hi - le
        if dhi > dlo:
            flags = self.stage_flags("dec_blocks", s)
            x = self._run_units(
                lambda h, bp: E.dec_block_apply(bp, h, mem, cfg), x,
                stage_tree["dec_blocks"][dlo:dhi],
                None if flags is None else flags[dlo:dhi])
        return ({"mem": mem, "x": x},
                torch.zeros((), dtype=F32, device=x.device))

    def head_loss(self, shared, bnd, mb):
        from repro_torch.models import encdec as E
        from repro_torch.models import layers as L
        x = E._ln(bnd["x"], shared, "final_norm", self.cfg)
        logits = L.lm_logits(x, shared["embed"]["tok"], tie=True)
        return L.cross_entropy(logits, mb["labels"], mb.get("mask"))
