"""Shared fixtures of the benchmark's CPU tests: a root of tiny cells.

The tiny cells copy the real configurations and mixes and cut them to CPU
size (4 layers, d_model 64, vocab 256, 4 x 32 tokens, rank 8), in fp32
where the port's CPU path and the reference should agree to rounding, and
with the port's plain orthonormalisation (QR) on the CPU.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "bench"
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"num_layers": 4, "d_model": 64, "num_heads": 4, "d_ff": 128,
        "vocab_size": 256, "max_position": 64}
# fp32 both sides: the limits hold rounding only (products of a few
# hundred terms in another order, about 1e-6 relative)
MIXES = ("flat.r64", "flat.none", "pipe4.overlap", "dp4.r64")
FP32_LIMITS = {"loss_gap": 1e-4, "entropy_gap": 1e-4, "grad_norm_gap": 1e-4,
               "change_gap": 1e-4}


def make_root(dest: Path) -> Path:
    """A copy of ``bench/`` with tiny cells ``tiny-<model>.<mix>``."""
    root = dest / "bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for cfg, tiny, kv in (("gpt2-2.5b.d8", "tiny-gpt2", 4), ("qwen2.5-3b.d8", "tiny-qwen", 2)):
        c = json.loads((root / "configs" / f"{cfg}.json").read_text())
        for dt, tag in (("float32", ""), ("bfloat16", "-bf16")):
            c["model"].update(TINY, num_kv_heads=kv, dtype=dt)
            (root / "configs" / f"{tiny}{tag}.json").write_text(json.dumps(c))
    for mix in MIXES:
        t = json.loads((root / "traffic" / f"{mix}.json").read_text())
        t.update(batch=8 if "pipeline" in t else 4, seq=32, rank=8,
                 orthonormalisation={"method": "qr"})
        if "pipeline" in t:
            t["pipeline"]["overlap_sync"] = False
        if t["layout"] == "dp":
            t["replicas"] = 2
        (root / "traffic" / f"tiny.{mix}.json").write_text(json.dumps(t))
    for cfg in ("tiny-gpt2", "tiny-qwen", "tiny-gpt2-bf16", "tiny-qwen-bf16"):
        for mix in MIXES:
            name = f"{cfg}.{mix}"
            (root / "workloads" / f"{name}.json").write_text(json.dumps(
                {"config": cfg, "traffic": f"tiny.{mix}", "chips": 1}))
            (root / "limits" / f"{name}.json").write_text(json.dumps(FP32_LIMITS))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("tiny"))


def run_tiny(root: Path, name: str, **kw) -> dict:
    from bench import harness
    kw.setdefault("device", "cpu")
    kw.setdefault("use_kernels", False)
    return harness.execute(name, kw.pop("seed", 2 ** 31 + 7), kw.pop("seconds", 0.2),
                           kw.pop("trace", False), root=root, **kw)
