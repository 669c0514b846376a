"""The flat step: one process, one card, ``Trainer.run`` with no pipe and no
mesh (the DP mean over a world of one is the identity)."""
from bench import harness, weights


def processes(mix: dict) -> int:
    return 1


def build(run, model, m: dict, mix: dict):
    return harness.make_trainer(model, m, mix, run.seed, run.device, run.use_kernels)


def units(trainer, m: dict, which: str) -> dict:
    """The units of the parameters (``params``) or of AdamW's first moment
    (``opt_m``)."""
    return weights.units_of_flat(m, trainer.state[which])
