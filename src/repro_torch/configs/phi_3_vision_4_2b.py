"""Phi-3-vision — phi3-mini decoder + stubbed CLIP frontend
[hf:microsoft/Phi-3-vision-128k-instruct]."""
import dataclasses
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, num_patches=576,
    num_stages=4, dtype="bfloat16", remat=True,
)
REDUCED = ModelConfig(
    name="phi3v-smoke", family="vlm",
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512, num_patches=16,
)
LONG_CONTEXT = dataclasses.replace(FULL, sliding_window=8192)
SHARDING_MODE = "dp_tp"
