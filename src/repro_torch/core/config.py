"""SyncConfig + the shared legacy-field shim for the unified config surface.

Port of ``repro/core/config.py``. ``resolve_embedded`` folds the old flat
keyword arguments (``num_stages``, ``use_kernels``, ...) into the embedded
``PipelineConfig`` / ``SyncConfig``; ``alias_property`` keeps them readable.
"""
from __future__ import annotations

import dataclasses

__all__ = ["SyncConfig", "SYNC_FIELDS", "COMM_MODES", "WIRE_MODES",
           "DEFAULT_BUCKET_BYTES", "resolve_embedded", "alias_property"]

#: Communication modes of the SyncExecutor facade (only "flat" is ported).
COMM_MODES = ("flat", "per-stage", "per-stage-overlapped")
from .wire import WIRE_MODES
DEFAULT_BUCKET_BYTES = 32 << 20     # 32 MiB of fp32 per flat bucket


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """DP gradient-sync executor knobs (hashable).

    ``bucketed``: True = shape-grouped stacked compression + flat buckets,
    False = the per-leaf parity oracle, None = let the trainer decide
    (bucketed). ``use_kernels`` routes the PowerSGD products through the
    Hopper kernels of ``repro_torch.kernels``.
    """

    bucketed: bool | None = None
    use_kernels: bool = False
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    #: Wire format under the collectives (``core/wire.py`` WIRE_MODES):
    #: raw | quant8 | quant4 | entropy. Anything but raw needs the bucketed
    #: executor (the per-leaf path stays the uncoded parity oracle).
    wire: str = "raw"
    #: The resolved static quantizer (``wire.ChunkCodec``), filled in by the
    #: trainer from ``wire`` and the controller's entropy reading; it keys
    #: the step cache. None = resolve it from ``wire``.
    codec: object | None = None


SYNC_FIELDS = tuple(f.name for f in dataclasses.fields(SyncConfig))


def resolve_embedded(pipeline, sync, legacy: dict, where: str):
    """Fold deprecated flat config kwargs into the embedded configs.

    Unknown names raise ``TypeError`` like a bad keyword. Returns the
    resolved ``(PipelineConfig, SyncConfig)`` pair.
    """
    from repro_torch.pipeline.config import PIPELINE_FIELDS, PipelineConfig

    pipe_over = {k: v for k, v in legacy.items() if k in PIPELINE_FIELDS}
    sync_over = {k: v for k, v in legacy.items() if k in SYNC_FIELDS}
    unknown = set(legacy) - set(pipe_over) - set(sync_over)
    if unknown:
        raise TypeError(f"{where} got unexpected keyword argument(s) "
                        f"{sorted(unknown)}")
    if pipeline is None:
        pipeline = PipelineConfig()
    if sync is None:
        sync = SyncConfig()
    if pipe_over:
        pipeline = dataclasses.replace(pipeline, **pipe_over)
    if sync_over:
        sync = dataclasses.replace(sync, **sync_over)
    return pipeline, sync


def alias_property(container: str, name: str, settable: bool = False):
    """A ``cfg.<name>`` property delegating to ``cfg.<container>.<name>``."""
    def get(self):
        return getattr(getattr(self, container), name)

    def set_(self, value):
        setattr(self, container,
                dataclasses.replace(getattr(self, container), **{name: value}))

    return property(get, set_ if settable else None,
                    doc=f"Deprecated alias for .{container}.{name}")
