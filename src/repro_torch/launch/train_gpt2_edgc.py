"""End to end: EDGC against the no-compression baseline, same seed and data.

Port of ``examples/train_gpt2_edgc.py``, which reproduces Table III's core
claim at fidelity scale: near-identical final loss and a large cut in the
DP-sync bytes. Its settings: ``GPT2_FIDELITY`` on ``SyntheticLM`` batches
of 8 x 128 at seed 0, 4 stages, GDS alpha 0.5 and beta 0.25, a DAC window
of 50 steps (at most 4 rank moves a window), AdamW at 1e-3 with 30
warm-up steps, 300 steps of policy ``none`` and then of ``edgc``. Runs on
CUDA unless ``--device`` names another device:

  PYTHONPATH=src python -m repro_torch.launch.train_gpt2_edgc
  PYTHONPATH=src python -m repro_torch.launch.train_gpt2_edgc --device cpu

The reference builds ``make_host_mesh()``, a mesh of one device; the port
runs without a mesh, one data-parallel worker, which is the same
computation.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.gpt2 import GPT2_FIDELITY
from repro_torch.core import EDGCConfig, GDSConfig
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, resolve_device

STEPS = 300
WINDOW = 50
LOG_EVERY = 50


def make_trainer(policy: str, steps: int = STEPS, window: int = WINDOW,
                 device=None) -> Trainer:
    """The example's trainer under ``policy`` for ``steps`` steps (the
    reference's settings; ``window`` is the DAC's)."""
    edgc = EDGCConfig(policy=policy, num_stages=4, total_iterations=steps,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=window, adjust_limit=4))
    tcfg = TrainerConfig(total_steps=steps, log_every=LOG_EVERY,
                         adam=AdamConfig(lr=1e-3, warmup_steps=30,
                                         total_steps=steps))
    return Trainer(build_model(GPT2_FIDELITY), edgc, tcfg,
                   device=resolve_device(device))


def batches():
    """The example's stream: 8 x 128 tokens a batch, seed 0."""
    return SyntheticLM(vocab_size=GPT2_FIDELITY.vocab_size, seq_len=128,
                       batch_size=8, seed=0).batches()


def run(trainer: Trainer) -> tuple[float, float]:
    """Every remaining step of ``trainer``: (final loss, DP-sync bytes
    saved against no compression)."""
    hist = trainer.run(batches())
    return hist[-1]["loss"], trainer.comm_savings()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    loss_none, _ = run(make_trainer("none", device=device))
    edgc = make_trainer("edgc", device=device)
    loss_edgc, saved = run(edgc)
    print(f"no-compression final loss : {loss_none:.4f}")
    print(f"EDGC           final loss : {loss_edgc:.4f}  "
          f"(gap {loss_edgc - loss_none:+.4f})")
    print(f"EDGC DP-sync bytes saved  : {saved:.1%}")
    print(f"EDGC stage ranks at the end: {edgc.history[-1]['ranks']} "
          f"on {device}")
    return {"loss_none": loss_none, "loss_edgc": loss_edgc, "saved": saved,
            "ranks": edgc.history[-1]["ranks"]}


if __name__ == "__main__":
    main()
