"""Architecture registry of the port: every arch of the reference.

``get_config(arch, variant)`` returns a ModelConfig; variants are
``full`` (published widths), ``reduced`` (CPU-scale) and ``long``, the
long-context decode variant (the full widths at ``sliding_window=8192``,
xlstm-125m's recurrent state as published, ``None`` for gpt2 and
whisper-base, whose contexts are bounded). ``sharding_mode(arch)`` is the
step mode a config trains under on a mesh: ``dp_tp``, or ``auto`` for the
three whose replicated parameters cannot fit (``train.step``).
``INPUT_SHAPES`` are the dry run's four input shapes, the reference's
(``repro/configs/__init__.py``) verbatim.
"""
from __future__ import annotations

import importlib

ARCHS: dict[str, str] = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "xlstm-125m": "xlstm_125m",
    "qwen3-32b": "qwen3_32b",
    "qwen2-0.5b": "qwen2_0_5b",
    "zamba2-7b": "zamba2_7b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "qwen2.5-3b": "qwen2_5_3b",
    "llama3-405b": "llama3_405b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "whisper-base": "whisper_base",
    "gpt2": "gpt2",
}

INPUT_SHAPES: dict[str, dict] = {
    "train_4k":    {"seq_len": 4096,    "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768,   "global_batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq_len": 32768,   "global_batch": 128, "kind": "decode"},
    "long_500k":   {"seq_len": 524288,  "global_batch": 1,   "kind": "decode"},
}


def arch_module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str, variant: str = "full"):
    mod = arch_module(arch)
    if variant == "full":
        return mod.FULL
    if variant == "reduced":
        return mod.REDUCED
    if variant == "long":
        return mod.LONG_CONTEXT
    raise ValueError(f"unknown variant {variant!r}")


def sharding_mode(arch: str) -> str:
    return arch_module(arch).SHARDING_MODE
