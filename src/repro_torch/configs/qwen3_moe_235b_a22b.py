"""Qwen3-MoE-235B-A22B — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
import dataclasses
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936,
    num_experts=128, experts_per_token=8,
    num_stages=4, dtype="bfloat16", remat=True,
)
REDUCED = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, num_experts=4, experts_per_token=2,
)
LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)
SHARDING_MODE = "auto"
