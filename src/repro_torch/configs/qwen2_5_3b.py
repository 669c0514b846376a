"""Qwen2.5-3B — dense, GQA kv=2, QKV bias [hf:Qwen/Qwen2.5-0.5B]."""
import dataclasses
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    num_stages=4, dtype="bfloat16", remat=True,
)
REDUCED = ModelConfig(
    name="qwen2.5-smoke", family="dense",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, qkv_bias=True, tie_embeddings=True,
)
LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)
SHARDING_MODE = "dp_tp"
