"""Architecture registry of the port: the reference's archs of the families
ported so far (dense, MoE, VLM; xLSTM, Zamba2 and Whisper are ROADMAP
Queue 1 items 9d-9f).

``get_config(arch, variant)`` returns a ModelConfig; variants are
``full`` (published widths) and ``reduced`` (CPU-scale).
"""
from __future__ import annotations

import importlib

ARCHS: dict[str, str] = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-32b": "qwen3_32b",
    "qwen2-0.5b": "qwen2_0_5b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "qwen2.5-3b": "qwen2_5_3b",
    "llama3-405b": "llama3_405b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "gpt2": "gpt2",
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
    raise ValueError(f"unknown variant {variant!r}")
