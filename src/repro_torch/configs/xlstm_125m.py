"""xLSTM-125M — alternating sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.models.model import ModelConfig

FULL = ModelConfig(
    name="xlstm-125m", family="xlstm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    chunk=128, num_stages=2, dtype="bfloat16", remat=True,
)
REDUCED = ModelConfig(
    name="xlstm-smoke", family="xlstm",
    num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
    d_ff=0, vocab_size=512, chunk=16,
)
LONG_CONTEXT = FULL  # recurrent state: long_500k runs natively
SHARDING_MODE = "dp_tp"
