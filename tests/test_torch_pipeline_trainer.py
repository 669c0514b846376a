"""The port's pipelined trainer (``Trainer(..., pipe=S)``) against the
reference's pipelined trainer and against the port's own flat trainer; its
refusals and the ``--pipe``/``--trace`` command line.

The reference runs at S = 1 in this process, on a mesh with a ``pipe``
axis built by hand with Auto axes (``jax.make_mesh`` builds Explicit axes
under jax 0.9, on which the reference's embed gather raises); its S = 4
run is in ``test_torch_pipeline_dist.py``. The port starts from the
reference's state (weights and warm starts: the warm starts come from
``jax.random`` there).

Bars: losses within 5e-3 of the reference's (``test_torch_trainer.py``'s
bar) and of the flat trainer's, entropy within 1e-4 of the reference's,
``bytes_synced`` equal.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.core import EDGCConfig as RefEDGCConfig
from repro.core import GDSConfig as RefGDSConfig
from repro.core.dac import DACConfig as RefDACConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.model import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch.core import EDGCConfig, GDSConfig
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import from_reference
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.faults import parse_inject
from repro_torch.train.step import TrainStepConfig, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

STEPS = 4
MODEL = dict(name="pp", family="dense", num_layers=4, d_model=128,
             num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)
DATA = dict(vocab_size=512, seq_len=32, batch_size=8, seed=3)


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _kw(S, policy, schedule, micro, stash, steps):
    edgc = dict(policy=policy, fixed_rank=8, num_stages=S,
                total_iterations=steps)
    tcfg = dict(total_steps=steps, log_every=1, schedule=schedule,
                num_microbatches=micro, stash_policy=stash)
    return edgc, tcfg


def _port(S, pipe, policy="fixed", schedule="1f1b", micro=2, stash="replay",
          steps=STEPS, layers=4, alpha=0.5, **tkw):
    edgc, tcfg = _kw(S, policy, schedule, micro, stash, steps)
    cfg = ModelConfig(**dict(MODEL, num_layers=layers, num_stages=S))
    return Trainer(
        build_model(cfg),
        EDGCConfig(gds=GDSConfig(alpha=alpha, beta=0.25),
                   dac=DACConfig(window=3, adjust_limit=4), **edgc),
        TrainerConfig(adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                      total_steps=steps), **tcfg, **tkw),
        seed=0, device="cpu", pipe=pipe)


def _ref_s1(schedule, stash, alpha):
    devs = np.array(jax.devices()[:1]).reshape(1, 1, 1)
    mesh = Mesh(devs, ("pipe", "data", "model"),
                axis_types=(AxisType.Auto,) * 3)
    edgc, tcfg = _kw(1, "fixed", schedule, 2, stash, STEPS)
    return RefTrainer(
        ref_build_model(RefModelConfig(**dict(MODEL, num_stages=1))), mesh,
        RefEDGCConfig(gds=RefGDSConfig(alpha=alpha, beta=0.25),
                      dac=RefDACConfig(window=3, adjust_limit=4), **edgc),
        RefTrainerConfig(adam=RefAdamConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=STEPS), **tcfg),
        seed=0)


def _check(got, want, bar=5e-3):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for a, b in zip(got, want, strict=True):
        assert abs(a["loss"] - b["loss"]) < bar, (a, b)
        assert a["bytes_synced"] == b["bytes_synced"]
        assert a["bytes_full"] == b["bytes_full"]
        assert a["stage_bytes"] == b["stage_bytes"]


@pytest.mark.parametrize("schedule,stash,alpha", [
    ("1f1b", "replay", 0.5), ("gpipe", "replay", 1.0), ("1f1b", "full", 1.0),
    ("gpipe", "every_k", 1.0)])
def test_pipelined_trainer_s1_equals_reference(schedule, stash, alpha):
    """S = 1, M = 2 on both packages: the whole executor (microbatch ring,
    stash segments, manual backward, per-stage sync) on one stage. One run
    gates the entropy every other step (two step variants); the others
    measure every step, so the reference compiles one variant."""
    ref = _ref_s1(schedule, stash, alpha)
    port = _port(1, 1, schedule=schedule, stash=stash, alpha=alpha)
    port.state = from_reference(jax.device_get(ref.state))
    want = ref.run(RefSyntheticLM(**DATA).batches())
    got = port.run(SyntheticLM(**DATA).batches())
    _check(got, want)
    for a, b in zip(got, want):
        assert abs(a["entropy"] - b["entropy"]) < 1e-4, (a, b)


@pytest.mark.parametrize("schedule,stash,micro", [
    ("1f1b", "replay", 4), ("gpipe", "full", 8), ("1f1b", "every_k", 4)])
def test_pipelined_s4_equals_flat_trainer(schedule, stash, micro):
    """The port's S = 4 pipelined trainer against its flat trainer on the
    same weights and batches: the microbatch split only reorders fp32
    sums. Eight layers give every_k (k = 2) a stash point per stage."""
    flat = _port(4, None, layers=8).run(SyntheticLM(**DATA).batches())
    tr = _port(4, 4, schedule=schedule, stash=stash, micro=micro, layers=8)
    got = tr.run(SyntheticLM(**DATA).batches())
    _check(got, flat)
    assert tr.pipelined and tr.state["stage_params"]["blocks"]["attn"][
        "wq"].shape[:2] == (4, 2)


def test_pipelined_edgc_replans_and_resizes_the_stage_state():
    """edgc at S = 4 (a ragged 6-layer plan, [2, 2, 1, 1]): the DAC leaves
    warm-up, the rank vector has S non-decreasing entries (Algorithm 2),
    the per-stage bytes are ``stage_wire_bytes`` of the applied plan, and
    the re-plan resized the compressor state."""
    tr = _port(4, 4, policy="edgc", micro=4, steps=12, layers=6)
    q0 = {k: v.q.shape for k, v in tr.state["comp"].items()}
    # ten steps: the last re-plan (at step 8) is the plan step 9 runs under
    hist = tr.run(SyntheticLM(**DATA).batches(), num_steps=10)
    assert all(np.isfinite(h["loss"]) for h in hist)
    ranks = tr.controller.rank_history[-1][1]
    assert len(ranks) == 4 and list(ranks) == sorted(ranks)
    assert hist[-1]["stage_bytes"] == tr.stage_bytes()
    q1 = {k: v.q.shape for k, v in tr.state["comp"].items()}
    assert q1 != q0
    assert len(hist[-1]["ranks"]) == 4
    assert len(tr._last_stage_entropy) == 4


# ------------------------------------------------ refusals, the CLI
def test_pipelined_trainer_refusals():
    with pytest.raises(ValueError, match="nan_grad/corrupt_payload"):
        _port(2, 2, faults=parse_inject("nan_grad@1"))
    with pytest.raises(ValueError, match="pipe=3 != num_stages=2"):
        _port(2, 3)
    # overlap_sync is no longer refused: the trainer plans the drain
    tr = _port(2, 2, overlap_sync=True)
    assert tr.overlap_plan is not None and all(tr.overlap_plan.feasible)
    assert tr.controller.dac.slack_seconds is not None
    with pytest.raises(ValueError, match="gaussian"):
        tr = _port(2, 2)
        tr.edgc_cfg = dataclasses.replace(
            tr.edgc_cfg, gds=GDSConfig(estimator="histogram"))
        tr._get_step(True)
    edgc, tcfg = _kw(2, "fixed", "1f1b", 2, "replay", 2)
    with pytest.raises(ValueError, match="no stage adapter"):
        Trainer(_FakeModel(), EDGCConfig(**edgc), TrainerConfig(**tcfg),
                device="cpu", pipe=2)
    tr = _port(2, 2)
    with pytest.raises(ValueError, match="unknown schedule"):
        make_train_step(tr.model, TrainStepConfig(
            pipeline=dataclasses.replace(tr.pipeline_cfg, schedule="zig")))
    with pytest.raises(ValueError, match="unknown stash policy"):
        make_train_step(tr.model, TrainStepConfig(
            pipeline=dataclasses.replace(tr.pipeline_cfg, stash_policy="x")))
    with pytest.raises(RuntimeError, match="flat trainer"):
        tr._reset_comp_state()


def test_distpipe_step_needs_an_explicit_dp_mean(tmp_path):
    """The default DP mean spans the default group, which under a DistPipe
    holds the pipe ranks: a DistPipe step without ``psum_mean`` raises
    rather than averaging the stages with one another."""
    import torch.distributed as dist
    from repro_torch.pipeline.executor import DistPipe
    tr = _port(1, 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="explicit psum_mean"):
            make_train_step(tr.model, TrainStepConfig(
                pipeline=tr.pipeline_cfg), pipe=DistPipe(1))
        make_train_step(tr.model, TrainStepConfig(pipeline=tr.pipeline_cfg),
                        psum_mean=lambda x: x, pipe=DistPipe(1))
    finally:
        dist.destroy_process_group()


class _FakeModel:
    """A model of a family that no package registers (so it has no stage
    adapter)."""

    def __init__(self):
        cfg = ModelConfig(**dict(MODEL, num_stages=2))
        real = build_model(cfg)
        self.config = dataclasses.replace(cfg, family="nope")
        self.init, self.loss_fn = real.init, real.loss_fn


def test_launch_pipe_trace_on_cpu(tmp_path, capsys):
    """``--pipe 2 --trace`` on the CPU, then the report re-emits the trace:
    both validate, with one span per tick-table entry."""
    from repro_torch.launch import report
    from repro_torch.launch.train import main
    from repro_torch.obs.trace import (expected_span_count, load_trace,
                                       validate_trace)
    trace_path, runs = str(tmp_path / "t.json"), str(tmp_path / "runs")
    hist = main(["--arch", "gpt2", "--variant", "reduced", "--policy", "edgc",
                 "--pipe", "2", "--micro", "4", "--schedule", "gpipe",
                 "--stash", "full", "--steps", "4", "--window", "2",
                 "--batch", "4", "--seq", "16", "--trace", trace_path,
                 "--metrics-dir", runs, "--device", "cpu"])
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "pipe=2 (gpipe, stash=full)" in out and "trace:" in out
    stats = validate_trace(load_trace(trace_path))
    n = stats["by_cat"]["forward"] + stats["by_cat"]["backward"]
    assert n == expected_span_count("gpipe", 2, 4) == 16
    assert stats["tracks"] == 2
    report.main([runs, "--trace", str(tmp_path / "r.json")])
    out = capsys.readouterr().out
    assert "pipeline: S=2 M=4 gpipe stash=full overlap_sync=False" in out
    assert "bubble fraction: 0.200" in out and "stage entropy (last)" in out
    validate_trace(load_trace(str(tmp_path / "r.json")))
    # --overlap and --chunk-bytes without --pipe run the flat trainer, which
    # ignores them, as the reference's launcher does
    assert len(main(["--steps", "1", "--batch", "2", "--seq", "16",
                     "--overlap", "--chunk-bytes", "1024",
                     "--device", "cpu"])) == 1
    for bad in (["--trace", trace_path], ["--data-mesh", "2"]):
        with pytest.raises(SystemExit):
            main(["--steps", "1", "--device", "cpu"] + bad)


def test_launch_overlap_trace_on_cpu(tmp_path, capsys):
    """``--pipe 2 --overlap --chunk-bytes N --trace``: the trace's SYNC spans
    are the overlap plan's in-loop launches and its sync-residual spans the
    residual; the report prints the overlap line."""
    from repro_torch.launch import report
    from repro_torch.launch.train import main
    from repro_torch.obs.metrics import read_jsonl
    from repro_torch.obs.trace import load_trace, validate_trace
    trace_path, runs = str(tmp_path / "t.json"), str(tmp_path / "runs")
    hist = main(["--arch", "gpt2", "--variant", "reduced", "--policy",
                 "fixed", "--rank", "8", "--pipe", "2", "--micro", "4",
                 "--steps", "3", "--batch", "4", "--seq", "16", "--overlap",
                 "--chunk-bytes", "16384", "--trace", trace_path,
                 "--metrics-dir", runs, "--device", "cpu"])
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert "overlapped sync" in capsys.readouterr().out
    events = load_trace(trace_path)["traceEvents"]
    stats = validate_trace(load_trace(trace_path))
    sync = [(e["tid"], e["args"]["planned_tick"], e["args"]["chunk"])
            for e in events if e.get("cat") == "sync"]
    residual = [(e["tid"], e["args"]["chunk"]) for e in events
                if e.get("cat") == "sync-residual"]
    # the plan the run's trainer made, from its overlap_plan event
    meta = [r for r in read_jsonl(os.path.join(runs, "metrics.jsonl"))
            if r.get("name") == "overlap_plan"]
    assert len(meta) == 1
    plan = meta[0]["data"]
    assert [sum(1 for s, _, _ in sync if s == st) for st in range(2)] == \
        plan["in_loop"]
    assert [sum(1 for s, _ in residual if s == st) for st in range(2)] == \
        plan["residual"]
    assert plan["in_loop"][0] == 0 and plan["in_loop"][1] > 0
    assert stats["by_cat"]["sync"] == sum(plan["in_loop"])
    report.main([runs])
    out = capsys.readouterr().out
    assert "overlap_sync=True" in out and "overlap plan:" in out
