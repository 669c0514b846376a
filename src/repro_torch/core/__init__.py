"""EDGC core on torch: entropy -> CQM -> DAC control plane and PowerSGD sync."""
from .bucketing import BucketLayout, SyncChunk, make_bucket_layout, sync_chunks
from .comm_model import H100_SXM, CommModel, HardwareSpec, rank_bounds
from .config import COMM_MODES, SyncConfig
from .compressor import (
    NO_COMPRESSION,
    CompressionPlan,
    LeafInfo,
    classify_leaves,
    init_compressor_state,
    make_plan,
    plan_wire_bytes,
    resize_compressor_state,
    sync_grads,
)
from .controller import EDGCConfig, EDGCController
from .cqm import CQM, rank_from_entropy_delta, theoretical_error
from .dac import DAC, DACConfig, stage_aligned_ranks, window_rank_adjust
from .entropy import (
    GDSConfig,
    gaussian_entropy,
    grads_entropy,
    grads_entropy_per_leaf,
    histogram_entropy,
)
from .mp_law import GTable, g_table, mp_cdf, mp_support, sample_eigenvalues
from .powersgd import LowRankState, compress_leaf, gram_schmidt, init_leaf_state
from .sync_executor import SyncExecutor

__all__ = [
    "BucketLayout", "SyncChunk", "make_bucket_layout", "sync_chunks",
    "CommModel", "HardwareSpec", "H100_SXM", "rank_bounds",
    "COMM_MODES", "SyncConfig", "SyncExecutor",
    "CompressionPlan", "LeafInfo", "NO_COMPRESSION", "classify_leaves",
    "init_compressor_state", "make_plan", "plan_wire_bytes",
    "resize_compressor_state", "sync_grads",
    "EDGCConfig", "EDGCController",
    "CQM", "rank_from_entropy_delta", "theoretical_error",
    "DAC", "DACConfig", "stage_aligned_ranks", "window_rank_adjust",
    "GDSConfig", "gaussian_entropy", "grads_entropy",
    "grads_entropy_per_leaf", "histogram_entropy",
    "GTable", "g_table", "mp_cdf", "mp_support", "sample_eigenvalues",
    "LowRankState", "compress_leaf", "gram_schmidt", "init_leaf_state",
]
