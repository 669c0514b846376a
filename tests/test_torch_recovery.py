"""The recovery policy of the port's Trainer against the reference's, on the
same seeded batches from the same starting state (weights, moments and
warm-start Q carried across by ``from_reference``): a NaN gradient
skipped by the guard with an EF reset, a NaN loss rolled back through the
checkpoint ring (falling through a torn newest checkpoint), repeated
anomalies pinning uncompressed sync, and a checkpoint that pinned the
fallback restored across the packages.

Both trainers run step by step. Fresh warm starts, drawn at an EF reset
or a DAC re-plan, come from ``jax.random`` in the reference and from a
seeded ``torch.Generator`` in the port, so they are copied across after
such a step, as ``test_torch_trainer.py`` does at a re-plan. Bars:
recovery counters, ``(name, step)`` event sequences, counters and byte
ledgers exactly; losses and ``loss_ema`` within 5e-3 (relative for the
EMA); controller states exactly but for the measured entropies, which
are fp32 reductions of each framework's own and agree within 1e-4.

The reference runs on a 1 x 1 mesh built with Auto axes inside the test
(``jax.make_mesh`` builds Explicit axes under jax 0.9, on which the
reference's embed gather raises).
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.core import EDGCConfig as RefEDGCConfig
from repro.core import GDSConfig as RefGDSConfig
from repro.core import SyncConfig as RefSyncConfig
from repro.core import comm_model as ref_comm
from repro.core.dac import DACConfig as RefDACConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.model import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro.obs import MemorySink as RefMemorySink
from repro.obs import MetricsRegistry as RefMetricsRegistry
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.train.faults import RecoveryConfig as RefRecoveryConfig
from repro.train.faults import parse_inject as ref_parse_inject
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch import tree
from repro_torch.core import EDGCConfig, GDSConfig, SyncConfig
from repro_torch.core.comm_model import HardwareSpec
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import from_reference
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.obs import MemorySink, MetricsRegistry
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.faults import RecoveryConfig, parse_inject
from repro_torch.train.trainer import Trainer, TrainerConfig

TINY = dict(name="el", family="dense", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)
DATA = dict(vocab_size=512, seq_len=64, batch_size=4, seed=0)
LOSS_TOL = 5e-3
ENTROPY_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _pair(steps, *, policy="fixed", window=10, log_every=None, inject="",
          recovery=None, ckpt_every=0, ckpt_dir=None, wire="raw"):
    """(reference, port) trainers on TINY with the same knobs, each with a
    MemorySink registry; the port starts from the reference's state."""
    common = dict(policy=policy, fixed_rank=8, total_iterations=steps)
    rsync, psync = RefSyncConfig(wire=wire), SyncConfig(wire=wire)
    tkw = dict(total_steps=steps, log_every=log_every or steps,
               ckpt_every=ckpt_every)
    ref = RefTrainer(
        ref_build_model(RefModelConfig(**TINY)),
        Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
             axis_types=(AxisType.Auto,) * 2),
        RefEDGCConfig(gds=RefGDSConfig(alpha=0.5, beta=0.25),
                      dac=RefDACConfig(window=window, adjust_limit=4),
                      sync=rsync, **common),
        RefTrainerConfig(
            ckpt_path=str(ckpt_dir / "ref") if ckpt_dir else "ckpt/state",
            faults=ref_parse_inject(inject) if inject else None,
            recovery=(RefRecoveryConfig(**recovery) if recovery is not None
                      else None),
            sync=rsync, metrics=RefMetricsRegistry([RefMemorySink()]),
            adam=RefAdamConfig(lr=1e-3, warmup_steps=10, total_steps=steps),
            **tkw),
        seed=0)
    port = Trainer(
        build_model(ModelConfig(**TINY)),
        EDGCConfig(gds=GDSConfig(alpha=0.5, beta=0.25),
                   dac=DACConfig(window=window, adjust_limit=4),
                   hw=HardwareSpec(**dataclasses.asdict(ref_comm.TPU_V5E)),
                   sync=psync, **common),
        TrainerConfig(
            ckpt_path=str(ckpt_dir / "port") if ckpt_dir else "ckpt/state",
            faults=parse_inject(inject) if inject else None,
            recovery=(RecoveryConfig(**recovery) if recovery is not None
                      else None),
            sync=psync, metrics=MetricsRegistry([MemorySink()]),
            adam=AdamConfig(lr=1e-3, warmup_steps=10, total_steps=steps),
            **tkw),
        seed=0, device="cpu")
    port.state = from_reference(jax.device_get(ref.state))
    return ref, port


def _lockstep(ref, port, steps):
    """Both trainers one step (one ``run`` call) at a time; fresh warm
    starts of an EF reset or a re-plan are copied from the reference."""
    rd, pd = RefSyntheticLM(**DATA).batches(), SyntheticLM(**DATA).batches()
    resets = lambda t: t.recovery.ef_resets if t.recovery is not None else 0
    while getattr(ref, "_global_step", 0) < steps:
        plan, n_reset = ref.controller.plan.ranks, resets(ref)
        ref.run(rd, num_steps=1)
        port.run(pd, num_steps=1)
        assert port.controller.plan.ranks == ref.controller.plan.ranks
        assert port._global_step == ref._global_step
        if ref.controller.plan.ranks != plan or resets(ref) != n_reset:
            port.state["comp"] = from_reference(
                {"comp": jax.device_get(ref.state["comp"])})["comp"]


def _events(trainer):
    return [(e["name"], e["step"]) for e in trainer.metrics.sinks[0].events()]


def _assert_recovery_close(got: dict, want: dict) -> None:
    assert {k: v for k, v in got.items() if k != "loss_ema"} == \
        {k: v for k, v in want.items() if k != "loss_ema"}
    if want["loss_ema"] is None:
        assert got["loss_ema"] is None
    else:
        assert got["loss_ema"] == pytest.approx(want["loss_ema"],
                                                rel=LOSS_TOL)


def _assert_runs_agree(ref, port) -> None:
    _assert_recovery_close(port.recovery.as_dict(), ref.recovery.as_dict())
    assert len(port.history) == len(ref.history)
    for got, want in zip(port.history, ref.history):
        assert got["step"] == want["step"]
        assert abs(got["loss"] - want["loss"]) < LOSS_TOL, (got, want)
        for key in ("bytes_synced", "bytes_full", "stage_bytes", "ranks"):
            assert got[key] == want[key], key
        _assert_recovery_close(got["recovery"], want["recovery"])
    assert _events(port) == _events(ref)
    for name in ("ef_resets",):
        assert port.metrics.sinks[0].counters(name) == \
            ref.metrics.sinks[0].counters(name)
    assert (port.bytes_synced, port.bytes_full) == \
        (ref.bytes_synced, ref.bytes_full)
    for got in tree.leaves(port.state["params"]):
        assert torch.isfinite(got.float()).all()


def _assert_controllers_agree(got: dict, want: dict) -> None:
    """Exact but for the measured entropies (and the CQM anchor taken from
    one), which agree within ENTROPY_RTOL."""
    assert [s for s, _ in got["entropy_history"]] == \
        [s for s, _ in want["entropy_history"]]
    np.testing.assert_allclose([h for _, h in got["entropy_history"]],
                               [h for _, h in want["entropy_history"]],
                               rtol=ENTROPY_RTOL)
    np.testing.assert_allclose(got["window_h"], want["window_h"],
                               rtol=ENTROPY_RTOL)
    for key in ("h_anchor", "g_anchor"):
        if want["cqm"][key] is None:
            assert got["cqm"][key] is None
        else:
            assert got["cqm"][key] == pytest.approx(want["cqm"][key],
                                                    rel=ENTROPY_RTOL)
    floats = ("entropy_history", "window_h", "cqm")
    assert {k: v for k, v in got.items() if k not in floats} == \
        {k: v for k, v in want.items() if k not in floats}


def test_nan_skip_ef_reset_matches_reference():
    """``tests/test_elastic.py::test_nan_skip_ef_reset_and_convergence`` at
    16 steps: the guard refuses step 6's NaN update, the EF state resets,
    and the run converges on."""
    ref, port = _pair(16, inject="nan_grad@6", log_every=4,
                      recovery=dict(rollback=False))
    _lockstep(ref, port, 16)
    _assert_runs_agree(ref, port)
    rs = port.recovery
    assert rs.skipped_steps == 1 and rs.ef_resets == 1
    assert rs.anomalies == 1 and not rs.fallback
    assert port.history[-1]["loss"] < port.history[0]["loss"]
    assert _events(port)[1:] == [("fault_injected", 6), ("guard_skip", 6),
                                 ("ef_reset", 6), ("recovered", 7)]


@pytest.mark.parametrize("policy,inject,ckpt_every,steps,restored", [
    ("edgc", "nan_grad@8", 5, 16, 5),
    ("fixed", "torn_ckpt@4,nan_grad@6", 3, 10, 3)], ids=["edgc", "torn"])
def test_rollback_matches_reference(tmp_path, policy, inject, ckpt_every,
                                    steps, restored):
    """``tests/test_elastic.py::test_rollback_restores_step_and_window``
    shortened, and the torn-newest case: with the guard off the NaN lands
    in the weights, the next loss is NaN, and the run rolls back through
    the ring (past a torn ``_6`` to ``_3`` in the second case), replays to
    the end, and does not inject the one-shot faults again."""
    ref, port = _pair(steps, policy=policy, window=5, inject=inject,
                      log_every=1, ckpt_every=ckpt_every, ckpt_dir=tmp_path,
                      recovery=dict(guard_nonfinite=False, ckpt_ring=2,
                                    fallback_after=99))
    _lockstep(ref, port, steps)
    _assert_runs_agree(ref, port)
    assert port.recovery.rollbacks == 1 and port._global_step == steps
    (rb,) = port.metrics.sinks[0].events("rollback")
    assert rb["data"] == {"restored_step": restored}
    assert math.isfinite(port.history[-1]["loss"])
    faults = [e for e in _events(port) if e[0] == "fault_injected"]
    assert len(faults) == len(inject.split(","))
    sd = port.controller.state_dict()
    _assert_controllers_agree(sd, ref.controller.state_dict())
    assert not sd["fallback"]
    again, _ = _pair(steps, policy=policy, window=5)
    again.controller.load_state_dict(sd)
    assert again.controller.state_dict() == sd


def test_fallback_run_matches_reference():
    """Two guarded anomalies (a NaN gradient, then a poisoned compressor
    state) with ``fallback_after=2``: the second pins uncompressed sync,
    and every later step moves ``bytes_full``."""
    ref, port = _pair(9, inject="nan_grad@2,corrupt_payload@5", log_every=1,
                      recovery=dict(rollback=False, fallback_after=2))
    _lockstep(ref, port, 9)
    _assert_runs_agree(ref, port)
    rs = port.recovery
    assert (rs.skipped_steps, rs.ef_resets, rs.anomalies, rs.fallback) == \
        (2, 2, 2, True)
    assert port.controller.in_fallback and port.controller.plan.ranks == ()
    assert _events(port)[1:] == [
        ("fault_injected", 2), ("guard_skip", 2), ("ef_reset", 2),
        ("recovered", 3), ("fault_injected", 5), ("guard_skip", 5),
        ("ef_reset", 5), ("recovered", 6)]
    full = port.history[-1]["bytes_full"] - port.history[-2]["bytes_full"]
    for a, b in zip(port.history[5:], port.history[6:]):
        assert b["bytes_synced"] - a["bytes_synced"] == full


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoint_with_the_fallback_pinned_restores(tmp_path, direction):
    """A run pinned to uncompressed sync saves its pair; a fresh trainer of
    the other package restores it (controller pinned, no compressed
    leaves, the recovery counters back) and continues within the loss bar
    of the saver's own continuation."""
    ref, port = _pair(6, recovery=dict(rollback=False), log_every=1)
    saver, loader = (ref, port) if direction == "ref_to_port" else (port, ref)
    saver.controller.force_fallback()
    saver._apply_plan_change()
    saver.recovery.fallback = True
    saver.recovery.anomalies = 4
    data = (RefSyntheticLM if saver is ref else SyntheticLM)(**DATA).batches()
    saver.run(data, num_steps=3)
    path = str(tmp_path / "pinned")
    saver.save_checkpoint(path, step=3)
    rest_saver = saver.run(data, num_steps=3)[3:]

    fresh_ref, fresh_port = _pair(6, recovery=dict(rollback=False),
                                  log_every=1)
    loader = fresh_port if loader is port else fresh_ref
    assert loader.restore_checkpoint(path) == 3
    assert loader.controller.in_fallback
    assert loader.controller.plan.ranks == ()
    assert loader.recovery.fallback and loader.recovery.anomalies == 4
    ldata = (RefSyntheticLM if loader is fresh_ref else SyntheticLM)(
        **DATA).batches()
    for _ in range(3):
        next(ldata)
    rest = loader.run(ldata, num_steps=3)[-3:]
    for got, want in zip(rest, rest_saver, strict=True):
        assert got["step"] == want["step"]
        assert abs(got["loss"] - want["loss"]) < LOSS_TOL, (got, want)
        assert got["bytes_synced"] == want["bytes_synced"]
        assert got["bytes_full"] == want["bytes_full"]
