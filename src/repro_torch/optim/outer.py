"""DiLoCo-style outer optimizer: EDGC-compressed outer-delta sync.

Port of ``repro/optim/outer.py``. Each pod runs K inner Trainer steps on
its own data, then the pods all-reduce the OUTER DELTA (anchor params
minus the pod's params) through the same PowerSGD + error-feedback
machinery the inner loop uses, and a Nesterov-momentum outer update moves
the shared anchor. A second, independent EDGC control plane
(``EDGCController``, its DAC window counted in outer rounds) adapts the
outer rank from outer-delta entropy.

Execution: every pod lives in this process (``launch.mesh.make_pod_mesh``'s
carrier). The per-pod deltas are stacked on a leading pod dim, a 2-D leaf
(m, n) becoming (N, m, n) and a stacked block leaf (L, m, n) becoming
(N, L, m, n), which ``compress_leaf`` folds to (N·L, m, n): each PowerSGD
kernel runs over every pod's slices in one launch, and the carrier's
``pmean`` means the factors over the pods between them. Under a coded wire
each pod's payload is quantized, packed and unpacked on its own before the
mean, as each pod codes its own inside the reference's ``shard_map``.

The outer state keeps every pod's rows: each compressor leaf's warm-start
Q and EF carry the leading pod dim (N, ...), as the reference's do. The
outer EF is fp32 from the start (the reference's starts in the parameter
dtype and turns fp32 at the first round; the values agree). The Nesterov
update runs in fp32 on device tensors and casts back to the parameter
dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree
from repro_torch.core import (EDGCConfig, EDGCController, classify_leaves,
                              init_compressor_state, plan_wire_bytes,
                              sync_grads)
from repro_torch.core import wire
from repro_torch.core.comm_model import H100_SXM, HardwareSpec
from repro_torch.core.dac import DACConfig
from repro_torch.core.entropy import GDSConfig, grads_entropy
from repro_torch.core.powersgd import LowRankState, fold_in, resize_rank

__all__ = ["OuterConfig", "OuterOptimizer", "make_outer_sync_step"]

F32 = torch.float32
#: outer deltas ship in fp32 (they are parameter-scale, not gradient-scale)
_OUTER_BYTES_PER_ELEM = 4


def _coded_pod_pmean(carrier, codec):
    """The carrier's pod mean with every pod's slice coded on its own: a
    quantization group never spans two pods' payloads."""
    if codec is None:
        return carrier.pmean

    def pmean(x: torch.Tensor) -> torch.Tensor:
        rows = x.reshape((carrier.n_pods, -1))
        coded = torch.stack([wire.roundtrip_arr(r, codec) for r in rows])
        return carrier.pmean(coded.reshape(x.shape))

    return pmean


def make_outer_sync_step(carrier, plan, gds: GDSConfig, codec=None,
                         use_kernels: bool = False):
    """The compressed outer all-reduce for one plan.

    (delta, comp) -> (synced delta, new comp, entropy): per-leaf PowerSGD
    factor means + error feedback over the pods (plain means for
    uncompressed leaves), entropy measured on the synced delta, the
    reading the outer DAC window consumes. ``delta``'s leaves and
    ``comp``'s carry the leading pod dim. After the mean every pod's slice
    of the synced delta is the same, so the entropy reads pod 0's (the
    GDS sample of the N-fold stack would be another sample).
    """
    pmean = _coded_pod_pmean(carrier, codec)

    def step(delta, comp):
        synced, comp = sync_grads(delta, comp, plan, pmean,
                                  use_kernels=use_kernels, bucketed=False)
        h = grads_entropy(tree.tree_map(lambda a: a[0], synced), gds)
        return synced, comp, h

    return step


@dataclasses.dataclass(frozen=True)
class OuterConfig:
    """DiLoCo outer loop configuration (the reference's fields and
    defaults). ``outer_k`` inner steps per round; Nesterov outer SGD at lr
    0.7 / momentum 0.9; ``policy`` 'none' (plain fp32 all-reduce), 'fixed'
    (static rank) or 'edgc' (the outer DAC window, counted in rounds);
    ``wire`` codes the outer all-reduce (quant8 by default: cross-pod
    links are the scarcest)."""

    outer_k: int = 30
    lr: float = 0.7
    momentum: float = 0.9
    policy: str = "edgc"            # none | fixed | edgc
    fixed_rank: int = 32
    wire: str = "quant8"            # raw | quant8 | quant4 | entropy
    window: int = 2                 # outer DAC window, in ROUNDS
    adjust_limit: int = 8
    total_rounds: int = 100
    min_compress_dim: int = 64
    warmup_frac_min: float = 0.0    # rounds are scarce: allow early warm-up end


class OuterOptimizer:
    """Compressed outer-delta all-reduce + Nesterov outer update.

    Owns the outer EDGC control plane, the per-pod outer compressor state
    (warm-start Q + EF, leading pod dim), the outer momentum tree and the
    sync-step cache keyed by (plan, codec). Membership changes go through
    ``resize_pods``: surviving pods keep their EF rows, joiners start with
    the shared warm-start Q and zero EF. ``use_kernels`` runs the PowerSGD
    products through the Hopper kernels and ``hw`` prices the outer DAC's
    comm model: the fleet's ``sync.use_kernels`` and ``EDGCConfig.hw``.
    """

    def __init__(self, params: Any, cfg: OuterConfig, mesh, num_layers: int,
                 seed: int = 0, use_kernels: bool = False,
                 hw: HardwareSpec = H100_SXM) -> None:
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.leaves = classify_leaves(params, num_layers, 1,
                                      min_dim=cfg.min_compress_dim)
        self._edgc = EDGCConfig(
            policy=cfg.policy, fixed_rank=cfg.fixed_rank,
            total_iterations=cfg.total_rounds,
            gds=GDSConfig(alpha=1.0, beta=0.25),  # every round measured
            dac=DACConfig(window=cfg.window, adjust_limit=cfg.adjust_limit,
                          warmup_frac_min=cfg.warmup_frac_min),
            hw=hw)
        self._seed = fold_in(seed, 777)
        self.round_index = 0
        self.bytes_synced = 0
        self.bytes_wire_raw = 0      # same payloads priced uncoded
        self.bytes_full = 0
        self.entropy_log: list[tuple[int, float]] = []
        # entropy mode starts at its quant8 fallback until the first
        # round's reading sets the reference distribution
        self._codec = wire.resolve_codec(cfg.wire)
        self._sync_cache: dict[Any, Any] = {}
        self.set_mesh(mesh)
        self.momentum = tree.tree_map(
            lambda a: torch.zeros(a.shape, dtype=F32, device=self.device),
            params)
        self.controller = EDGCController(self._edgc, self.leaves,
                                         world=max(2, self.n_pods))
        self._comp = self._init_comp(params)

    # ------------------------------------------------------------------ mesh
    def set_mesh(self, mesh) -> None:
        """(Re)bind to a pod carrier; invalidates the sync cache."""
        self.mesh = mesh
        self.n_pods = mesh.n_pods
        self.device = mesh.device
        self._sync_cache.clear()

    @property
    def plan(self):
        return self.controller.plan

    # ------------------------------------------------------- compressor state
    def _fresh(self, params_like) -> dict[str, LowRankState]:
        return init_compressor_state(params_like, self.controller.plan,
                                     self._seed)

    def _stacked(self, st: LowRankState) -> LowRankState:
        """One leaf's warm start given to every pod, with zero fp32 EF."""
        q = st.q.to(self.device)
        return LowRankState(
            q=q[None].expand((self.n_pods,) + tuple(q.shape)).clone(),
            err=torch.zeros((self.n_pods,) + tuple(st.err.shape), dtype=F32,
                            device=self.device))

    def _init_comp(self, params) -> dict[str, LowRankState]:
        """Per-leaf outer compressor state, leading pod dim."""
        return {path: self._stacked(st)
                for path, st in self._fresh(params).items()}

    def _apply_plan_change(self, params_like) -> None:
        """Re-shape the outer compressor state to the controller's new plan:
        resized warm Q + EF for surviving leaves (row by row, so every pod
        draws the same new columns), fresh state for newly compressed ones.
        The stored pod dim can lag ``n_pods`` (a restore into a larger
        fleet): extra pods reuse row 0's warm Q, their EF rows start at
        zero, as ``resize_pods``'s joiners."""
        plan = self.controller.plan
        new: dict[str, LowRankState] = {}
        for path, st in self._fresh(params_like).items():
            old = self._comp.get(path)
            if old is None:
                new[path] = self._stacked(st)
                continue
            old_n = old.q.shape[0]
            rows = [resize_rank(
                LowRankState(q=old.q[i if i < old_n else 0],
                             err=(old.err[i] if i < old_n
                                  else torch.zeros_like(old.err[0]))),
                plan.rank_of(path), self._seed) for i in range(self.n_pods)]
            new[path] = LowRankState(q=torch.stack([r.q for r in rows]),
                                     err=torch.stack([r.err for r in rows]))
        self._comp = new
        self._sync_cache.clear()

    def resize_pods(self, mesh, survivors: list[int]) -> None:
        """Membership change: rebind to ``mesh`` (new pod count), survivors
        keep their rows (in ``survivors``' order), joiners get the shared
        warm-start Q (row parity is a PowerSGD requirement) and zero EF."""
        old_n = self.n_pods
        for i in survivors:
            if not 0 <= i < old_n:
                raise ValueError(f"survivor index {i} out of range for "
                                 f"{old_n} pods")
        self.set_mesh(mesh)
        n_new = self.n_pods

        def migrate(a: torch.Tensor, fill) -> torch.Tensor:
            rows = [a[i] for i in survivors]
            while len(rows) < n_new:          # joiners
                rows.append(fill(rows[0]))
            return torch.stack(rows[:n_new]).to(self.device)

        self._comp = {
            p: LowRankState(q=migrate(st.q, torch.clone),
                            err=migrate(st.err, torch.zeros_like))
            for p, st in self._comp.items()}

    # ------------------------------------------------------------- sync step
    def _get_sync(self, plan):
        key = (plan, self._codec)
        if key not in self._sync_cache:
            self._sync_cache[key] = make_outer_sync_step(
                self.mesh, plan, self._edgc.gds, codec=self._codec,
                use_kernels=self.use_kernels)
        return self._sync_cache[key]

    def _refresh_codec(self) -> None:
        """Entropy-mode wire coding: bit width from the latest outer-delta
        reading against the first round's, at window ends like the plan."""
        if self.cfg.wire != "entropy" or not self.entropy_log:
            return
        self._codec = wire.resolve_codec(
            "entropy", entropy_nats=self.entropy_log[-1][1],
            ref_nats=self.entropy_log[0][1])

    # ----------------------------------------------------------------- round
    @torch.no_grad()
    def round(self, anchor: Any, pod_deltas: list[Any]) -> tuple[Any, dict]:
        """One outer round: compressed all-reduce of the per-pod deltas,
        then the Nesterov outer update.

        ``anchor``: the shared params at the round start. ``pod_deltas``:
        one tree per pod, ``anchor - pod_params``. Returns (new anchor
        params, a tree of new tensors; round info dict).
        """
        if len(pod_deltas) != self.n_pods:
            raise ValueError(f"{len(pod_deltas)} pod deltas for "
                             f"{self.n_pods} pods")
        plan = self.controller.plan
        delta = tree.unflatten(pod_deltas[0], [
            torch.stack([d.to(self.device, F32) for d in ds])
            for ds in zip(*(tree.leaves(d) for d in pod_deltas))])
        synced, self._comp, h = self._get_sync(plan)(delta, self._comp)
        del delta
        h = float(h)
        self.entropy_log.append((self.round_index, h))
        self.controller.on_entropy(self.round_index, h)

        comp_b, full_b = plan_wire_bytes(self.leaves, plan,
                                         _OUTER_BYTES_PER_ELEM,
                                         codec=self._codec)
        raw_b = (plan_wire_bytes(self.leaves, plan, _OUTER_BYTES_PER_ELEM)[0]
                 if self._codec is not None else comp_b)
        self.bytes_synced += comp_b
        self.bytes_wire_raw += raw_b
        self.bytes_full += full_b

        # Nesterov outer SGD on the averaged pseudo-gradient (pod 0's slice)
        mu, lr = self.cfg.momentum, self.cfg.lr
        new_p, new_m = [], []
        for a, d, m in zip(tree.leaves(anchor), tree.leaves(synced),
                           tree.leaves(self.momentum)):
            a32 = a.to(self.device, F32)
            d32 = d[0]
            m2 = mu * m + d32
            new_m.append(m2)
            new_p.append((a32 - lr * (d32 + mu * m2)).to(a.dtype))
        self.momentum = tree.unflatten(self.momentum, new_m)
        new_params = tree.unflatten(anchor, new_p)

        self.round_index += 1
        plan_changed = False
        if self.round_index % self.cfg.window == 0:
            if self.controller.on_window_end(self.round_index - 1):
                self._apply_plan_change(anchor)
                plan_changed = True
            self._refresh_codec()
        info = {
            "round": self.round_index - 1,
            "entropy": h,
            "bytes_synced": comp_b,
            "bytes_full": full_b,
            "ranks": [r for _, r in plan.ranks[:4]],
            "plan_changed": plan_changed,
        }
        if self._codec is not None:
            info["bytes_wire_raw"] = raw_b
            info["wire_bits"] = int(self._codec.bits)
        return new_params, info

    # --------------------------------------------------------- checkpointing
    def state_dict(self) -> dict[str, Any]:
        """JSON control-plane state (the arrays ride the checkpoint tree)."""
        return {
            "controller": self.controller.state_dict(),
            "round_index": int(self.round_index),
            "n_pods": int(self.n_pods),
            "bytes_synced": int(self.bytes_synced),
            "bytes_wire_raw": int(self.bytes_wire_raw),
            "bytes_full": int(self.bytes_full),
            "entropy_log": [[int(r), float(h)] for r, h in self.entropy_log],
        }

    def load_state_dict(self, sd: dict[str, Any], params_like: Any) -> None:
        """The control plane first; the compressor state is re-shaped to the
        restored plan, and the arrays are loaded into it afterwards."""
        self.controller.load_state_dict(sd["controller"])
        self.round_index = int(sd["round_index"])
        self.bytes_synced = int(sd["bytes_synced"])
        self.bytes_wire_raw = int(sd.get("bytes_wire_raw", 0))
        self.bytes_full = int(sd["bytes_full"])
        self.entropy_log = [(int(r), float(h)) for r, h in sd["entropy_log"]]
        self._refresh_codec()   # entropy mode: codec from the restored log
        self._apply_plan_change(params_like)

    @property
    def arrays(self) -> dict[str, Any]:
        """The outer arrays for the checkpoint tree."""
        return {"outer_m": self.momentum, "outer_comp": self._comp}

    def load_arrays(self, arrs: dict[str, Any]) -> None:
        put = lambda t: tree.tree_map(lambda a: a.to(self.device), t)
        self.momentum = put(arrs["outer_m"])
        self._comp = {p: LowRankState(q=put(st.q), err=put(st.err).to(F32))
                      for p, st in arrs["outer_comp"].items()}

    def comm_savings(self) -> float:
        if self.bytes_full == 0:
            return 0.0
        return 1.0 - self.bytes_synced / self.bytes_full
