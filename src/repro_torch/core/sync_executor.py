"""SyncExecutor — the one entry point for DP gradient synchronization.

Port of ``repro/core/sync_executor.py``. Modes:

  flat                   ``sync(grads, comp, psum_mean)``: the whole
                         gradient tree under one CompressionPlan.
  per-stage              ``sync(stage_grads, comp, psum_mean,
                         shared_grads=..., my_stage=...)``: the schedule
                         of the stage's own plan, run after the pipeline
                         drains (``pipeline/sync.stage_sync_grads``).
  per-stage-overlapped   the same schedules split into
                         :class:`~repro_torch.core.bucketing.SyncChunk`s
                         that the pipelined executor launches inside its
                         drain ticks (``chunks`` / ``run_chunks`` /
                         ``sync_shared``); the chunks the launch plan left
                         over run through ``run_chunks`` after the loop.
"""
from __future__ import annotations

from typing import Any, Callable

from . import bucketing, wire
from .compressor import CompressionPlan, sync_grads
from .config import COMM_MODES, SyncConfig

__all__ = ["SyncExecutor"]

PsumFn = Callable[[Any], Any]


class SyncExecutor:
    """Facade over the flat, per-stage and overlapped DP-sync executors."""

    def __init__(self, cfg: SyncConfig | None = None, mode: str = "flat", *,
                 plan: CompressionPlan | None = None, splans=None,
                 donate: bool = False) -> None:
        if mode not in COMM_MODES:
            raise ValueError(f"unknown CommMode {mode!r} "
                             f"(want one of {COMM_MODES})")
        if mode == "flat" and plan is None:
            raise ValueError("mode='flat' requires a CompressionPlan")
        if mode != "flat" and splans is None:
            raise ValueError(f"mode={mode!r} requires StagePlans")
        self.cfg = cfg or SyncConfig()
        self.codec = self.resolve_codec(self.cfg)
        self.mode = mode
        self.plan = plan
        self.splans = splans
        self.donate = donate          # flat: EF residuals updated in place

    @staticmethod
    def resolve_codec(cfg: SyncConfig):
        """The ``wire.ChunkCodec`` that ``cfg`` syncs under (None = raw).

        ``cfg.codec`` when set (the trainer fills it in; entropy mode needs
        the controller's reading), else resolved from ``cfg.wire``. Coding
        rides on the bucketed executor only.
        """
        if cfg.wire not in wire.WIRE_MODES:
            raise ValueError(f"unknown wire mode {cfg.wire!r} "
                             f"(want one of {wire.WIRE_MODES})")
        codec = cfg.codec
        if codec is None and cfg.wire != "raw":
            codec = wire.resolve_codec(cfg.wire)
        if codec is not None and cfg.bucketed is False:
            raise ValueError(f"wire={cfg.wire!r} requires the bucketed "
                             "executor (SyncConfig.bucketed must not be False)")
        return codec

    def sync(self, grads: Any, comp_state: dict, psum_mean: PsumFn, *,
             shared_grads: Any = None, my_stage: int | None = None):
        """flat: returns (synced grads, new compressor state). per-stage
        modes: ``grads`` is one stage's tree, ``my_stage`` its index;
        returns (synced_stage, synced_shared, new_state), ``synced_shared``
        None when no ``shared_grads`` are given (in the overlapped mode this
        is the sync with no chunk launched early, equal to per-stage)."""
        if self.mode == "flat":
            return sync_grads(grads, comp_state, self.plan, psum_mean,
                              use_kernels=self.cfg.use_kernels,
                              bucketed=self.cfg.bucketed,
                              bucket_bytes=self.cfg.bucket_bytes,
                              codec=self.codec, donate=self.donate)
        from repro_torch.pipeline.sync import stage_sync_grads
        return stage_sync_grads(grads, shared_grads, comp_state, self.splans,
                                psum_mean, my_stage,
                                use_kernels=self.cfg.use_kernels,
                                codec=self.codec)

    def chunks(self, d: int) -> tuple[bucketing.SyncChunk, ...]:
        """Launchable chunks of distinct schedule ``d``."""
        return bucketing.sync_chunks(self.splans.layouts[d])

    def run_chunks(self, d: int, chunk_ids, grads_by_path: dict,
                   comp_state: dict, psum_mean: PsumFn):
        """Run a subset of schedule ``d``'s chunks for one stage.

        ``grads_by_path`` maps stage-local leaf paths to gradients in the
        parameter dtype (only the chunks' members are read). Returns
        (synced leaves by path, the full compressor dict with schedule
        ``d``'s touched keys replaced).
        """
        from repro_torch.pipeline.sync import stage_sync_chunks
        return stage_sync_chunks(grads_by_path, comp_state, self.splans, d,
                                 chunk_ids, psum_mean,
                                 use_kernels=self.cfg.use_kernels,
                                 codec=self.codec)

    def sync_shared(self, shared_grads: Any, psum_mean: PsumFn):
        """Flat-bucket sync of the shared leaves (never compressed)."""
        from repro_torch.pipeline.sync import sync_shared_grads
        return sync_shared_grads(shared_grads, psum_mean)
