"""Architecture registry of the port (the dense configs ported so far).

``get_config(arch, variant)`` returns a ModelConfig; variants are
``full`` (published widths) and ``reduced`` (CPU-scale).
"""
from __future__ import annotations

import importlib

ARCHS: dict[str, str] = {
    "qwen2-0.5b": "qwen2_0_5b",
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
