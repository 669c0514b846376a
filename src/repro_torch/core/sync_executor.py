"""SyncExecutor — the one entry point for DP gradient synchronization.

Port of ``repro/core/sync_executor.py``, flat mode: the whole gradient
tree synced under one CompressionPlan by ``compressor.sync_grads``. The
per-stage modes belong to the pipelined executor (ROADMAP Queue 1 item 8)
and raise.
"""
from __future__ import annotations

from typing import Any, Callable

from . import wire
from .compressor import CompressionPlan, sync_grads
from .config import COMM_MODES, SyncConfig

__all__ = ["SyncExecutor"]

PsumFn = Callable[[Any], Any]


class SyncExecutor:
    """Facade over the DP-sync executors (flat mode ported)."""

    def __init__(self, cfg: SyncConfig | None = None, mode: str = "flat", *,
                 plan: CompressionPlan | None = None) -> None:
        if mode not in COMM_MODES:
            raise ValueError(f"unknown CommMode {mode!r} "
                             f"(want one of {COMM_MODES})")
        if mode != "flat":
            raise NotImplementedError(
                f"mode={mode!r} needs the pipelined executor, not ported yet "
                "(ROADMAP Queue 1 item 8)")
        if plan is None:
            raise ValueError("mode='flat' requires a CompressionPlan")
        self.cfg = cfg or SyncConfig()
        self.codec = self.resolve_codec(self.cfg)
        self.mode = mode
        self.plan = plan

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

    def sync(self, grads: Any, comp_state: dict, psum_mean: PsumFn):
        """Returns (synced grads, new compressor state)."""
        return sync_grads(grads, comp_state, self.plan, psum_mean,
                          use_kernels=self.cfg.use_kernels,
                          bucketed=self.cfg.bucketed,
                          bucket_bytes=self.cfg.bucket_bytes,
                          codec=self.codec)
