"""Kimi K2 — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2]."""
import dataclasses
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    num_experts=384, experts_per_token=8,
    num_stages=4, dtype="bfloat16", remat=True,
)
REDUCED = ModelConfig(
    name="kimi-k2-smoke", family="moe",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512,
    num_experts=4, experts_per_token=2, num_stages=2,
)
LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)  # long_500k variant
SHARDING_MODE = "auto"
