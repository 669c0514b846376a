"""Serving launcher: batched generation with the decode engine (port of
``repro/launch/serve.py``). Runs on the current CUDA device unless
``--device`` names another:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --variant reduced --batch 4 --prompt-len 16 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The prompts are ``np.random.default_rng(seed)`` draws, as the reference's;
the weights are the port's own random ones from ``--seed``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.models.model import build_model, param_count
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train.trainer import resolve_device


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--variant", default="reduced", choices=["full", "reduced"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--bench-context", type=int, default=0,
                    help="if set, time decode at this context length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, args.variant)
    if cfg.family == "whisper":
        raise SystemExit("use repro_torch.launch.serve_decode for the "
                         "enc-dec path")
    device = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(args.seed, device)
    print(f"{cfg.name}: {param_count(params)/1e6:.1f}M params")

    eng = Engine(model, params, ServeConfig(max_new_tokens=args.new_tokens,
                                            temperature=args.temperature,
                                            seed=args.seed), device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    out = eng.generate(prompts)
    print(f"generated {out.shape} tokens; first row: {out[0][:16].tolist()}")

    if args.bench_context:
        s = eng.decode_benchmark(args.batch, args.bench_context)
        print(f"decode @ context={args.bench_context}, batch={args.batch}: "
              f"{s*1e3:.2f} ms/token")


if __name__ == "__main__":
    main()
