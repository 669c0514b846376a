"""Telemetry of the port against the reference: the registry's records,
deferred flush, sinks and cursor on the same inputs; the Trainer's record
stream against the reference Trainer's (the ledger-reconciling run of
``tests/test_obs.py``, a coded-wire run, and the fault-run event log);
the metrics cursor carried through a checkpoint; and the run report,
line for line.

Record streams compare kind, name, step and payload keys in order, with
byte ledgers, ranks, counters and integer series exact and float values
within 5e-3 (relative above 1); ``wall`` and ``wall_s`` are clocks and
are not compared. Both trainers run step by step from the same state;
fresh warm starts of a re-plan or an EF reset are copied from the
reference (``test_torch_recovery.py`` says why). The reference runs on a
1 x 1 mesh built with Auto axes inside the test.
"""
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
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
from repro.launch import report as ref_report
from repro.models.model import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro.obs import metrics as ref_metrics
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.train.faults import RecoveryConfig as RefRecoveryConfig
from repro.train.faults import parse_inject as ref_parse_inject
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch.core import EDGCConfig, GDSConfig, SyncConfig
from repro_torch.core.comm_model import HardwareSpec
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import from_reference
from repro_torch.launch import report
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.obs import metrics
from repro_torch.obs import (MemorySink, MetricsRegistry, profiler_session,
                             read_jsonl)
from repro_torch.optim.adam import AdamConfig
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.faults import RecoveryConfig, parse_inject
from repro_torch.train.trainer import Trainer, TrainerConfig

TINY = dict(name="obs", family="dense", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
            num_stages=2)
DATA = dict(vocab_size=512, seq_len=64, batch_size=4, seed=0)
TOL = 5e-3
INT_SCALARS = {"bytes_synced", "bytes_full", "wire_bytes_coded",
               "wire_bytes_raw", "wire_bits"}


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------- registry
def _drive_registry(mod, value):
    """The same emitter calls on either package's registry; ``value``
    turns a Python number into that package's device value."""
    sink = mod.MemorySink()
    reg = mod.MetricsRegistry([sink], tags={"run": "a"})
    reg.scalar("loss", 1.5, step=0)
    reg.scalar("dev", value(2.25), step=1)
    reg.series("ranks", [8, 16], step=0)
    reg.series("stage", [value(0.5), 3], step=2)
    reg.series("np", np.array([1, 2], dtype=np.int64), step=2)
    reg.scalar("np32", np.float32(0.5), step=2)
    assert reg.counter("resets", step=3) == 1
    assert reg.counter("resets", inc=2, step=4) == 3
    reg.event("boom", step=5, kind_detail="nan")
    reg.scalar("loss", 1.25)           # no step -> cursor (5)
    view = reg.with_tags(pod=1)
    view.scalar("loss", 9.0, step=6)
    view.with_tags(shard=2).event("nested", step=6)
    assert view.counter("resets", step=6) == 4
    reg.flush()
    return reg, sink


def _strip(records):
    return [{k: v for k, v in r.items() if k != "wall"} for r in records]


def test_registry_records_match_reference():
    ref_reg, ref_sink = _drive_registry(ref_metrics, jnp.float32)
    reg, sink = _drive_registry(metrics,
                                lambda x: torch.tensor(x, dtype=torch.float32))
    assert _strip(sink.records) == _strip(ref_sink.records)
    assert reg.state_dict() == ref_reg.state_dict()
    assert (reg.last_step, reg.n_emitted) == (6, 13)
    assert sink.scalars("loss") == ref_sink.scalars("loss")
    assert sink.series("stage") == [(2, [0.5, 3])]
    assert sink.counters("resets") == [(3, 1), (4, 3), (6, 4)]
    assert [e["name"] for e in sink.events()] == ["boom", "nested"]
    assert isinstance(sink.scalars("np32")[0][1], float)


def test_flush_defers_device_fetch_to_one_copy(monkeypatch):
    """Tensors stay tensors until flush; flush makes exactly one batched
    device-to-host copy (one ``fetch`` call) for everything pending, and
    the values equal the reference's for the same inputs."""
    calls = []
    real = metrics.fetch
    monkeypatch.setattr(metrics, "fetch",
                        lambda ts: calls.append(len(ts)) or real(ts))
    reg = MetricsRegistry([sink := MemorySink()])
    ref = ref_metrics.MetricsRegistry([ref_sink := ref_metrics.MemorySink()])
    for i in range(4):
        reg.scalar("x", torch.tensor(float(i)) * 2, step=i)
        ref.scalar("x", jnp.float32(i) * 2, step=i)
    reg.series("v", torch.arange(3, dtype=torch.float32), step=4)
    ref.series("v", jnp.arange(3, dtype=jnp.float32), step=4)
    reg.series("i", torch.arange(3, dtype=torch.int32), step=4)
    ref.series("i", jnp.arange(3, dtype=jnp.int32), step=4)
    reg.scalar("b", torch.tensor(True), step=4)
    ref.scalar("b", jnp.bool_(True), step=4)
    assert calls == [] and sink.records == []
    reg.flush()
    ref.flush()
    assert calls == [7]
    assert _strip(sink.records) == _strip(ref_sink.records)
    (sv,) = sink.series("v")
    assert sv[1] == [0.0, 1.0, 2.0] and all(isinstance(v, float)
                                            for v in sv[1])
    assert all(isinstance(v, int) for v in sink.series("i")[0][1])
    reg.flush()                       # nothing pending: no copy
    assert calls == [7]


def test_fetch_keeps_values_shapes_and_types():
    ts = [torch.tensor(1.5), torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
          torch.tensor(0.1, dtype=torch.bfloat16), torch.tensor(False),
          torch.tensor([float("nan"), 2.0])]
    got = metrics.fetch(ts)
    assert got[0] == 1.5 and got[1] == [[1, 2], [3, 4]]
    assert got[2] == float(torch.tensor(0.1, dtype=torch.bfloat16))
    assert got[3] is False and math.isnan(got[4][0]) and got[4][1] == 2.0
    assert metrics.fetch([]) == []


def test_jsonl_and_csv_match_reference(tmp_path):
    files = {}
    for name, mod in (("ref", ref_metrics), ("port", metrics)):
        path = str(tmp_path / name / "metrics.jsonl")
        reg = mod.MetricsRegistry([mod.JsonlSink(path)])
        reg.scalar("loss", 2.0, step=0)
        reg.series("ranks", [4, 8], step=1)
        reg.counter("resets", step=1)
        reg.event("plan_change", step=1, window=1)
        reg.close()
        reg2 = mod.MetricsRegistry([mod.JsonlSink(path)])   # append mode
        reg2.scalar("loss", 1.0, step=2)
        reg2.close()
        records = mod.read_jsonl(path)
        csv_path = str(tmp_path / name / "out.csv")
        mod.write_csv(records, csv_path)
        files[name] = (records, open(csv_path).read())
    assert _strip(files["port"][0]) == _strip(files["ref"][0])
    assert files["port"][1] == files["ref"][1]
    rows = files["port"][1].strip().splitlines()
    assert rows[:3] == ["step,name,kind,value", "0,loss,scalar,2.0",
                        "1,ranks,series,4;8"]
    assert len(rows) == 5            # the event is not tabular
    assert read_jsonl(str(tmp_path / "port" / "metrics.jsonl"))[-1]["step"] == 2


def test_cursor_roundtrip_matches_reference():
    out = {}
    for name, mod in (("ref", ref_metrics), ("port", metrics)):
        reg = mod.MetricsRegistry([mod.MemorySink()])
        reg.scalar("loss", 1.0, step=7)
        reg.counter("resets")
        reg.flush()
        sd = reg.state_dict()
        reg2 = mod.MetricsRegistry([sink2 := mod.MemorySink()])
        reg2.load_state_dict(sd)
        reg2.flush()
        assert reg2.counter("resets") == 2
        out[name] = (sd, _strip(sink2.records), reg2.state_dict())
    assert out["port"] == out["ref"]
    assert out["port"][1][0]["name"] == "telemetry_resume"


def test_profiler_session_writes_a_chrome_trace(tmp_path):
    with profiler_session(False, str(tmp_path / "off")) as off:
        assert off is None
    assert not (tmp_path / "off").exists()
    with profiler_session(True, str(tmp_path / "on")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "on" / "trace.json").read_text())
    assert logdir == str(tmp_path / "on") and trace["traceEvents"]


# ------------------------------------------------------ trainer telemetry
def _pair(steps, *, policy="edgc", window=8, log_every=2, wire="raw",
          inject="", recovery=None, ckpt_every=0, ckpt_dir=None):
    common = dict(policy=policy, fixed_rank=16, num_stages=2,
                  total_iterations=steps)
    rsync, psync = RefSyncConfig(wire=wire), SyncConfig(wire=wire)
    tkw = dict(total_steps=steps, log_every=log_every, ckpt_every=ckpt_every)
    ref = RefTrainer(
        ref_build_model(RefModelConfig(**TINY)),
        Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
             axis_types=(AxisType.Auto,) * 2),
        RefEDGCConfig(gds=RefGDSConfig(alpha=0.5, beta=0.25),
                      dac=RefDACConfig(window=window, adjust_limit=4),
                      sync=rsync, **common),
        RefTrainerConfig(
            ckpt_path=str(ckpt_dir / "ref") if ckpt_dir else "ckpt/obs",
            faults=ref_parse_inject(inject) if inject else None,
            recovery=(RefRecoveryConfig(**recovery) if recovery is not None
                      else None),
            sync=rsync,
            metrics=ref_metrics.MetricsRegistry([ref_metrics.MemorySink()]),
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
            ckpt_path=str(ckpt_dir / "port") if ckpt_dir else "ckpt/obs",
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
    rd, pd = RefSyntheticLM(**DATA).batches(), SyntheticLM(**DATA).batches()
    resets = lambda t: t.recovery.ef_resets if t.recovery is not None else 0
    while getattr(ref, "_global_step", 0) < steps:
        plan, n_reset = ref.controller.plan.ranks, resets(ref)
        ref.run(rd, num_steps=1)
        port.run(pd, num_steps=1)
        if ref.controller.plan.ranks != plan or resets(ref) != n_reset:
            port.state["comp"] = from_reference(
                {"comp": jax.device_get(ref.state["comp"])})["comp"]


def _close(got, want) -> bool:
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    return abs(got - want) <= TOL * max(1.0, abs(want))


def _assert_records_agree(got: list[dict], want: list[dict]) -> None:
    key = lambda r: (r["kind"], r["name"], r["step"])
    assert [key(r) for r in got] == [key(r) for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), key(w)
        kind, name = w["kind"], w["name"]
        if kind == "scalar" and name != "wall_s":
            if name in INT_SCALARS:
                assert g["value"] == w["value"], key(w)
            else:
                assert _close(g["value"], w["value"]), (g, w)
        elif kind == "series":
            if all(isinstance(v, int) for v in w["values"]):
                assert g["values"] == w["values"], key(w)
            else:
                np.testing.assert_allclose(g["values"], w["values"], rtol=TOL)
        elif kind == "counter":
            assert (g["value"], g["inc"]) == (w["value"], w["inc"])
        elif kind == "event":
            assert set(g["data"]) == set(w["data"]), key(w)
            for k, v in w["data"].items():
                if k == "path":         # each package writes its own files
                    assert os.path.basename(g["data"][k]).split("_")[-1] == \
                        os.path.basename(v).split("_")[-1]
                elif isinstance(v, float):
                    assert _close(g["data"][k], v), (k, g, w)
                else:
                    assert g["data"][k] == v, (k, g, w)


@pytest.mark.parametrize("policy,wire,steps,window", [
    ("edgc", "raw", 22, 8), ("fixed", "entropy", 12, 4)])
def test_trainer_telemetry_matches_reference(policy, wire, steps, window):
    """``tests/test_obs.py::test_trainer_series_reconcile_with_ledgers`` on
    both packages (and a coded wire with its wire scalars): the same
    records in the same order, and the series reconcile with the port's
    own ledgers."""
    ref, port = _pair(steps, policy=policy, window=window, wire=wire)
    _lockstep(ref, port, steps)
    sink = port.metrics.sinks[0]
    _assert_records_agree(sink.records, ref.metrics.sinks[0].records)

    ledger = port.stage_bytes()
    step, last_swb = sink.series("stage_wire_bytes")[-1]
    assert step == steps - 1 and last_swb == [int(c) for c, _ in ledger]
    assert sink.series("stage_wire_bytes_full")[-1][1] == \
        [int(f) for _, f in ledger]
    assert sink.scalars("bytes_synced")[-1][1] == port.bytes_synced
    assert sink.scalars("bytes_full")[-1][1] == port.bytes_full
    ranks = sink.series("dac_applied_ranks")
    assert ranks and ranks[-1][1] == [
        int(r) for r in port.controller.dac.current_ranks()]
    assert [s for s, _ in sink.scalars("loss")] == \
        [h["step"] for h in port.history]
    names = {e["name"] for e in sink.events()}
    assert "run_meta" in names
    if policy == "edgc":
        assert "plan_change" in names
    else:
        assert sink.scalars("wire_bits") and sink.scalars("wire_reduction")


def test_fault_run_event_log_matches_reference():
    """``tests/test_obs.py::test_fault_run_event_log_sequence`` on both
    packages: nan_grad -> guard skip + EF reset -> recovered, in order,
    and the whole record stream alike."""
    ref, port = _pair(24, policy="fixed", window=8, log_every=24,
                      inject="nan_grad@12", recovery=dict(rollback=False))
    _lockstep(ref, port, 24)
    sink = port.metrics.sinks[0]
    _assert_records_agree(sink.records, ref.metrics.sinks[0].records)
    assert port.recovery.skipped_steps == 1 and port.recovery.ef_resets == 1
    seq = [(e["name"], e["step"]) for e in sink.events()
           if e["name"] in ("fault_injected", "guard_skip", "ef_reset",
                            "recovered")]
    assert seq == [("fault_injected", 12), ("guard_skip", 12),
                   ("ef_reset", 12), ("recovered", 13)]
    (fault,) = sink.events("fault_injected")
    assert fault["data"] == {"kind": "nan_grad", "at": 12}
    assert sink.counters("ef_resets")[-1][1] == 1


def test_trainer_fetches_once_per_flush(monkeypatch):
    """The trainer reads its buffered step metrics in one copy per flush
    point (log steps, window ends, run end); under recovery it adds the
    documented per-step read of the loss and guard flag."""
    calls = []
    real = trainer_mod.fetch
    monkeypatch.setattr(trainer_mod, "fetch",
                        lambda ts: calls.append(len(ts)) or real(ts))
    _, port = _pair(8, policy="fixed", window=4, log_every=3)
    port.run(SyntheticLM(**DATA).batches())
    # flush points: steps 0, 3, 6 (logged), 3, 7 (window ends; 7 is also
    # the last step), and the run end
    assert len(calls) == 5 and sum(calls) == 8 * 5
    calls.clear()
    _, port = _pair(8, policy="fixed", window=4, log_every=3,
                    recovery=dict(rollback=False))
    port.run(SyntheticLM(**DATA).batches())
    assert calls.count(2) == 8 and len(calls) == 8 + 5


def test_checkpoint_carries_metrics_cursor(tmp_path):
    """``tests/test_obs.py::test_checkpoint_carries_metrics_cursor``: the
    cursor rides in the pair; a fresh trainer of either package restores
    it from the reference's pair or the port's and emits the same
    ``telemetry_resume``."""
    ref, port = _pair(12, policy="fixed", window=6, log_every=4,
                      ckpt_every=6, ckpt_dir=tmp_path)
    _lockstep(ref, port, 12)
    assert port.metrics.state_dict() == ref.metrics.state_dict()
    resumes = []
    for path in (tmp_path / "ref_12", tmp_path / "port_12"):
        for fresh in _pair(12, policy="fixed", window=6, log_every=4):
            fresh.metrics.sinks[0].records.clear()
            assert fresh.restore_checkpoint(str(path)) == 12
            fresh.metrics.flush()
            (ev,) = fresh.metrics.sinks[0].events("telemetry_resume")
            assert fresh.metrics.last_step == 11
            resumes.append((ev["step"], ev["data"]))
    assert len(set(map(json.dumps, resumes))) == 1
    assert resumes[0][1]["emitted"] > 0


# ------------------------------------------------------------------ report
def _report_records(tmp_path):
    """Record streams that reach every report section the flat trainer
    feeds: a coded-wire edgc run with plan changes, and a fault run."""
    ref, port = _pair(12, policy="edgc", window=4, log_every=1,
                      wire="quant8")
    _lockstep(ref, port, 12)
    fref, fport = _pair(8, policy="fixed", window=4, log_every=2,
                        inject="nan_grad@3,corrupt_payload@5",
                        recovery=dict(rollback=False))
    _lockstep(fref, fport, 8)
    return [t.metrics.sinks[0].records for t in (ref, port, fref, fport)]


def test_build_report_matches_reference_line_for_line(tmp_path, capsys):
    streams = _report_records(tmp_path)
    for records in streams:
        lines = report.build_report(records)
        assert lines == ref_report.build_report(records)
    fault = report.build_report(streams[3])
    assert "fault/recovery timeline:" in fault
    assert any("guard_skip" in line for line in fault)
    assert any(line.startswith("wire coding:")
               for line in report.build_report(streams[1]))
    assert report.build_report([]) == ["(no recognizable telemetry records)"]

    run = tmp_path / "run"
    run.mkdir()
    with open(run / "metrics.jsonl", "w") as f:
        for r in streams[3]:
            f.write(json.dumps(r) + "\n")
    report.main([str(run), "--csv", str(tmp_path / "m.csv")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith(f"metrics.jsonl: {len(streams[3])} records")
    assert out[1:-1] == fault
    assert (tmp_path / "m.csv").exists()
    with pytest.raises(SystemExit, match="pipelined run"):
        report.main([str(run), "--trace", str(tmp_path / "t.json")])
    with pytest.raises(SystemExit, match="no metrics.jsonl"):
        report.main([str(tmp_path)])
