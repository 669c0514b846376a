"""Qwen2-0.5B — dense, GQA kv=2, QKV bias, tied embeddings [arXiv:2407.10671]."""
import dataclasses
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    num_stages=4, dtype="bfloat16", remat=True,
)
REDUCED = ModelConfig(
    name="qwen2-smoke", family="dense",
    num_layers=2, d_model=224, num_heads=7, num_kv_heads=1,
    d_ff=512, vocab_size=512, qkv_bias=True, tie_embeddings=True,
)
LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)
SHARDING_MODE = "dp_tp"
