"""Qwen3-32B — dense, GQA kv=8, qk-norm [hf:Qwen/Qwen3-8B]."""
import dataclasses
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    d_ff=25600, vocab_size=151936, head_dim=128, qk_norm=True,
    num_stages=4, dtype="bfloat16", remat=True,
)
REDUCED = ModelConfig(
    name="qwen3-smoke", family="dense",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, head_dim=64, qk_norm=True,
)
LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)
SHARDING_MODE = "dp_tp"
