"""Faults planted under the timed path, for the check that ``correct``
catches them (``tests/test_bench_faults.py``, ``control.py``). Each takes
the run after its trainer is built and breaks it in place."""
from __future__ import annotations

from bench import harness


def unchanged(run) -> None:
    """Every step returns the state it was given, unchanged."""
    tr = run.trainer
    get = tr._get_step

    def frozen_step(measure):
        step = get(measure)

        def call(state, batch):
            import torch
            keep = _tree_clone(state, torch)
            _, mets = step(state, batch)
            return keep, mets
        return call
    tr._get_step = frozen_step


def _tree_clone(t, torch):
    if isinstance(t, dict):
        return {k: _tree_clone(v, torch) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        out = [_tree_clone(v, torch) for v in t]
        return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
    return t.clone() if isinstance(t, torch.Tensor) else t


def half_batch(run) -> None:
    """Each step sees the first half of its rows only, its mean taken over them."""
    tr = run.trainer
    rows = tr._device_batch
    tr._device_batch = lambda b: {k: v[: v.shape[0] // 2] for k, v in rows(b).items()}


def no_exchange(run) -> None:
    """The DP mean between replicas is left out: each keeps its own."""
    import repro_torch.train.trainer as port_trainer
    port_trainer.make_dp_pmean = lambda group=None: (lambda x: x)


def diverges(run) -> None:
    """Training diverges after the first steps: from the first step of the
    window on, every weight update is infinite (the window's state ends
    not finite)."""
    tr = run.trainer
    get = tr._get_step
    calls = [0]

    def poisoned(measure):
        step = get(measure)

        def call(state, batch):
            calls[0] += 1
            if calls[0] > harness.CHECK_STEPS + harness.TIME_STEPS:
                next(harness._tensors(state)).fill_(float("inf"))
            return step(state, batch)
        return call
    tr._get_step = poisoned


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "no_exchange": no_exchange,
          "diverges": diverges}
