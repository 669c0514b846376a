"""Quickstart: train a small GPT-2 with EDGC and watch the ranks adapt.

Port of ``examples/quickstart.py``, with its settings: ``GPT2_FIDELITY``
on ``SyntheticLM`` batches of 8 x 128, policy edgc over 4 stages, GDS
alpha 0.5 and beta 0.25, a DAC window of 40 steps (at most 4 rank moves
a window), AdamW at 1e-3 with 20 warm-up steps, 200 steps. Runs on CUDA
unless ``--device`` names another device:

  PYTHONPATH=src python -m repro_torch.launch.quickstart
  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

The reference builds ``make_host_mesh()``, a mesh of one device; the port
runs without a mesh, one data-parallel worker, which is the same
computation. It prints the model's size, the controller's description,
one line every 20 steps (loss, entropy, the stage ranks: empty during the
DAC's warm-up) and the DP-sync bytes saved against no compression.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.gpt2 import GPT2_FIDELITY
from repro_torch.core import EDGCConfig, GDSConfig
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import build_model, param_count
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, resolve_device

STEPS = 200
WINDOW = 40
LOG_EVERY = 20


def make_trainer(steps: int = STEPS, window: int = WINDOW, device=None
                 ) -> Trainer:
    """The example's trainer for ``steps`` steps (the reference's
    settings; ``window`` is the DAC's)."""
    edgc = EDGCConfig(policy="edgc", num_stages=4, total_iterations=steps,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=window, adjust_limit=4))
    tcfg = TrainerConfig(total_steps=steps, log_every=LOG_EVERY,
                         adam=AdamConfig(lr=1e-3, warmup_steps=20,
                                         total_steps=steps))
    return Trainer(build_model(GPT2_FIDELITY), edgc, tcfg,
                   device=resolve_device(device))


def batches():
    """The example's stream: 8 x 128 tokens a batch, seed 0."""
    return SyntheticLM(vocab_size=GPT2_FIDELITY.vocab_size, seq_len=128,
                       batch_size=8).batches()


def run(trainer: Trainer) -> list[dict]:
    """Every remaining step of ``trainer``; its logged history."""
    return trainer.run(batches())


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    trainer = make_trainer(device=args.device)
    print(f"model: {param_count(trainer.state['params']) / 1e6:.1f}M params "
          f"on {trainer.device}")
    print(f"EDGC: {trainer.controller.describe()}")
    hist = run(trainer)
    for h in hist:
        print(f"step {h['step']:4d}  loss {h['loss']:.3f}  entropy "
              f"{h['entropy']:+.3f}  stage-ranks {h['ranks']}")
    print(f"\nDP-sync bytes saved vs no compression: "
          f"{trainer.comm_savings():.1%}")
    return hist


if __name__ == "__main__":
    main()
