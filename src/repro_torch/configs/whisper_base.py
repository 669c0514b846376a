"""Whisper-base — enc-dec, conv frontend stubbed [arXiv:2212.04356]."""
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="whisper-base", family="whisper",
    num_layers=6, encoder_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, audio_frames=1500,
    max_position=1 << 16, num_stages=1, dtype="bfloat16", remat=True,
)
REDUCED = ModelConfig(
    name="whisper-smoke", family="whisper",
    num_layers=2, encoder_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, audio_frames=30, max_position=4096,
)
LONG_CONTEXT = None  # skipped: whisper's decoder context is architecturally bounded
SHARDING_MODE = "dp_tp"
