"""Llama-3-405B — dense, GQA kv=8, 128k vocab [arXiv:2407.21783]."""
import dataclasses
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256, head_dim=128,
    num_stages=6, dtype="bfloat16", remat=True,
)
REDUCED = ModelConfig(
    name="llama3-smoke", family="dense",
    num_layers=2, d_model=512, num_heads=8, num_kv_heads=2,
    d_ff=1024, vocab_size=512, head_dim=64,
)
LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)
SHARDING_MODE = "auto"
