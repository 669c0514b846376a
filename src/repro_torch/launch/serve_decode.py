"""Serve small models with batched requests through the decode path,
Whisper's audio -> tokens path included (port of
``examples/serve_decode.py``). Runs on the current CUDA device unless
``--device`` names another:

  PYTHONPATH=src python -m repro_torch.launch.serve_decode
  PYTHONPATH=src python -m repro_torch.launch.serve_decode --device cpu

It samples 16 tokens of the reduced qwen2-0.5b through ``Engine`` at
temperature 0.8, then decodes 12 greedy tokens of the reduced Whisper
from stub frames (the cross K/V precomputed by ``encdec.init_cache``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import encdec
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train.trainer import resolve_device


def run(device) -> list[str]:
    """The two lines the script prints."""
    lines = []
    # --- decoder-only (qwen2 reduced) -----------------------------------
    cfg = get_config("qwen2-0.5b", "reduced")
    model = build_model(cfg)
    params = model.init(0, device)
    eng = Engine(model, params, ServeConfig(max_new_tokens=16,
                                            temperature=0.8), device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 8)).astype(np.int32)
    out = eng.generate(prompts)
    lines.append(f"qwen2 reduced: generated {out.shape}; "
                 f"row0={out[0].tolist()}")

    # --- enc-dec (whisper reduced): audio frames -> tokens -----------------
    wcfg = get_config("whisper-base", "reduced")
    wmodel = build_model(wcfg)
    wparams = wmodel.init(1, device)
    frames = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (2, wcfg.audio_frames, wcfg.d_model)) * 0.1).astype(np.float32))
    with torch.inference_mode():
        cache = encdec.init_cache(wcfg, 2, 32, frames=frames.to(device),
                                  params=wparams, device=device)
        tok = torch.zeros((2,), dtype=torch.int64, device=device)
        toks = []
        for _ in range(12):
            logits, cache = wmodel.decode_step(wparams, cache, tok)
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
        decoded = torch.stack(toks, dim=1).to(torch.int32).cpu().numpy()
    lines.append(f"whisper reduced: decoded {decoded.tolist()}")
    return lines


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    for line in run(resolve_device(args.device)):
        print(line)


if __name__ == "__main__":
    main()
