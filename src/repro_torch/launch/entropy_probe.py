"""Probe the gradient entropy estimators (Obs. 1 demo, Lemma 2 sanity).

Port of ``examples/entropy_probe.py``. Runs on CUDA unless ``--device``
names another device; on the card the ``kernel`` column bins through the
histogram kernel:

  PYTHONPATH=src python -m repro_torch.launch.entropy_probe
  PYTHONPATH=src python -m repro_torch.launch.entropy_probe --device cpu

For each sigma it prints the Gaussian (Lemma 2), plain histogram and
kernel-binned histogram estimates of a seeded N(0, sigma^2) sample beside
the closed form; then the histogram entropy of strided beta-samples of
one N(0, 1) sample.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch.core.entropy import (gaussian_entropy, histogram_entropy,
                                      strided_sample)
from repro_torch.kernels import ops
from repro_torch.train.trainer import resolve_device

SIGMAS = (1.0, 0.1, 0.01)
BETAS = (1.0, 0.25, 0.05)


def estimators(x: torch.Tensor) -> dict[str, float]:
    """The three estimates of one flat sample, in nats."""
    return {"gaussian": float(gaussian_entropy(x)),
            "hist": float(histogram_entropy(x)),
            "kernel": float(ops.sampled_entropy_hist(x))}


def probe(device) -> list[str]:
    """The probe's lines, from ``np.random.default_rng(0)`` as the JAX
    example draws them."""
    rng = np.random.default_rng(0)
    lines = []
    for sigma in SIGMAS:
        x = torch.from_numpy(rng.standard_normal(200_000).astype(np.float32)
                             * sigma).to(device)
        h_theory = math.log(sigma) + 0.5 * math.log(2 * math.pi * math.e)
        est = estimators(x)
        lines.append(f"sigma={sigma:6.3f}  gaussian={est['gaussian']:+.4f}  "
                     f"hist={est['hist']:+.4f}  kernel={est['kernel']:+.4f}  "
                     f"theory={h_theory:+.4f}")
    x = torch.from_numpy(rng.standard_normal(1_000_000).astype(np.float32)
                         ).to(device)
    for beta in BETAS:
        s = strided_sample(x, beta)
        lines.append(f"beta={beta:4.2f}  sample={s.shape[0]:8d}  "
                     f"H={float(histogram_entropy(s)):+.4f}")
    return lines


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines = probe(device)
    print(f"entropy probe on {device}")
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
