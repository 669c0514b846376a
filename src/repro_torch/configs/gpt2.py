"""GPT-2 family — the paper's own models (Table II) + fidelity reductions.

GPT2-345M/2.5B/12.1B as Megatron configured them (LayerNorm, plain GeLU,
learned positions, MHA). ``GPT2_FIDELITY`` is the CPU-scale reduction used
by the EXPERIMENTS.md paper-fidelity runs (entropy decay, CQM, Tables).
"""
from repro_torch.models.model import ModelConfig

GPT2_345M = ModelConfig(
    name="gpt2-345m", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=50257, norm="layernorm", act="gelu_plain",
    pos="learned", tie_embeddings=True, max_position=1024,
    num_stages=4, dtype="bfloat16", remat=True,
)
GPT2_2_5B = ModelConfig(
    name="gpt2-2.5b", family="dense",
    num_layers=52, d_model=1920, num_heads=20, num_kv_heads=20,
    d_ff=7680, vocab_size=50257, norm="layernorm", act="gelu_plain",
    pos="learned", tie_embeddings=True, max_position=1024,
    num_stages=4, dtype="bfloat16", remat=True,   # paper: TP4/DP2/PP4
)
GPT2_12_1B = ModelConfig(
    name="gpt2-12.1b", family="dense",
    num_layers=76, d_model=3584, num_heads=28, num_kv_heads=28,
    d_ff=14336, vocab_size=50257, norm="layernorm", act="gelu_plain",
    pos="learned", tie_embeddings=True, max_position=1024,
    num_stages=4, dtype="bfloat16", remat=True,   # paper: TP4/DP4/PP4
)
GPT2_FIDELITY = ModelConfig(
    name="gpt2-fidelity", family="dense",
    num_layers=4, d_model=256, num_heads=8, num_kv_heads=8,
    d_ff=1024, vocab_size=2048, norm="layernorm", act="gelu_plain",
    pos="learned", tie_embeddings=True, max_position=512,
    num_stages=4,
)
FULL = GPT2_2_5B
REDUCED = GPT2_FIDELITY
LONG_CONTEXT = None
SHARDING_MODE = "dp_tp"
