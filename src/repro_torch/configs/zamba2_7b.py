"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
import dataclasses
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b", family="zamba",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, ssm_state=64, conv_kernel=4,
    chunk=128, attn_every=7, num_stages=4, dtype="bfloat16", remat=True,
)
REDUCED = ModelConfig(
    name="zamba2-smoke", family="zamba",
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, ssm_state=16, chunk=16, attn_every=2,
)
LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)
SHARDING_MODE = "dp_tp"
