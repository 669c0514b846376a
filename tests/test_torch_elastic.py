"""The port's elastic outer loop (``repro_torch.train.elastic``) against the
reference's (``repro/train/elastic.py``).

The reference's ``ElasticTrainer`` builds its meshes through
``make_host_mesh`` and ``make_pod_mesh``, which give Explicit axes under
jax 0.9, on which its trainer fails; the harness replaces both, in
``repro.train.elastic``'s namespace only, by Auto-axis meshes (nothing of
``src/repro`` changes). Several pods need a subprocess with four host
devices; one pod runs in this process.

An EF reset draws a fresh warm start from each framework's own RNG; the
parity run copies the reference's (ROADMAP Queue 3, "warm starts").
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

import repro.train.elastic as ref_elastic
from repro.core import EDGCConfig as RefEDGCConfig
from repro.core import GDSConfig as RefGDSConfig
from repro.core import comm_model as ref_comm
from repro.core.dac import DACConfig as RefDACConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.launch.report import build_report as ref_build_report
from repro.models.model import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.optim.outer import OuterConfig as RefOuterConfig
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch import tree
from repro_torch.core import EDGCConfig, GDSConfig
from repro_torch.core.comm_model import HardwareSpec
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import from_reference
from repro_torch.launch import train as launch_train
from repro_torch.launch.report import build_report
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.obs import MemorySink, MetricsRegistry
from repro_torch.obs.metrics import read_jsonl
from repro_torch.optim.adam import AdamConfig
from repro_torch.optim.outer import OuterConfig
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.elastic import ElasticTrainer
from repro_torch.train.faults import RecoveryConfig, parse_inject
from repro_torch.train.trainer import TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(name="el", family="dense", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)
K = 5
LOSS_TOL = 5e-3                  # the trainer parity tests' loss bar
REF_HW = HardwareSpec(**dataclasses.asdict(ref_comm.TPU_V5E))
CPUS = ["cpu"] * 4


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _batch_fn(pod):
    return SyntheticLM(512, 64, 4, seed=100 + pod).batches()


def _port(tmp_path, rounds, n_pods=2, inject=None, recovery=None,
          log_every=1, metrics=None, devices=CPUS, use_kernels=False,
          wire="quant8"):
    steps = rounds * K
    edgc = EDGCConfig(policy="fixed", fixed_rank=8, total_iterations=steps,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=10, adjust_limit=4), hw=REF_HW,
                      use_kernels=use_kernels)
    tcfg = TrainerConfig(total_steps=steps, log_every=log_every,
                         ckpt_path=str(tmp_path / "st"),
                         faults=parse_inject(inject) if inject else None,
                         recovery=recovery, metrics=metrics,
                         use_kernels=use_kernels,
                         adam=AdamConfig(lr=1e-3, warmup_steps=5,
                                         total_steps=steps))
    ocfg = OuterConfig(outer_k=K, policy="fixed", fixed_rank=8, window=2,
                       total_rounds=rounds, wire=wire)
    return ElasticTrainer(build_model(ModelConfig(**TINY)), edgc, tcfg, ocfg,
                          n_pods, _batch_fn, devices=devices)


def _auto_meshes(monkeypatch):
    """The reference's elastic mesh builders, as Auto-axis meshes."""
    def host_mesh(data=1, model=1, pod=0, pipe=0, devices=None):
        devs = np.array(devices if devices is not None else jax.devices())
        return Mesh(devs[:data * model].reshape(data, model),
                    ("data", "model"), axis_types=(AxisType.Auto,) * 2)

    def pod_mesh(n_pods, devices=None):
        devs = np.array(devices if devices is not None else jax.devices())
        return Mesh(devs[:n_pods], ("pod",), axis_types=(AxisType.Auto,))
    monkeypatch.setattr(ref_elastic, "make_host_mesh", host_mesh)
    monkeypatch.setattr(ref_elastic, "make_pod_mesh", pod_mesh)


def _ref(tmp_path, rounds):
    """The reference's one-pod fleet, in this process."""
    steps = rounds * K
    edgc = RefEDGCConfig(policy="fixed", fixed_rank=8, total_iterations=steps,
                         gds=RefGDSConfig(alpha=0.5, beta=0.25),
                         dac=RefDACConfig(window=10, adjust_limit=4))
    tcfg = RefTrainerConfig(total_steps=steps, log_every=1,
                            ckpt_path=str(tmp_path / "ref_st"),
                            adam=RefAdamConfig(lr=1e-3, warmup_steps=5,
                                               total_steps=steps))
    ocfg = RefOuterConfig(outer_k=K, policy="fixed", fixed_rank=8, window=2,
                          total_rounds=rounds)
    return ref_elastic.ElasticTrainer(
        ref_build_model(RefModelConfig(**TINY)), edgc, tcfg, ocfg, 1,
        lambda pod: RefSyntheticLM(512, 64, 4, seed=100 + pod).batches())


def _close(got, want, rtol=1e-3, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _ptrs(et) -> list[int]:
    """Storage pointers of every pod's parameters and of the anchor."""
    return [a.untyped_storage().data_ptr()
            for t in [tr.state["params"] for tr in et.pods] + [et.anchor]
            for a in tree.leaves(t)]


# --------------------------------------------- parity with the reference
_REF_ELASTIC = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import AxisType, Mesh
    import repro.train.elastic as E
    from repro.core import EDGCConfig, GDSConfig, init_compressor_state
    from repro.core.dac import DACConfig
    from repro.data.pipeline import SyntheticLM
    from repro.models.model import ModelConfig, build_model
    from repro.optim.adam import AdamConfig
    from repro.optim.outer import OuterConfig
    from repro.train.faults import RecoveryConfig, parse_inject
    from repro.train.trainer import TrainerConfig, replicate_comp_state

    E.make_host_mesh = lambda data=1, model=1, devices=None: Mesh(
        np.array(devices).reshape(1, 1), ("data", "model"),
        axis_types=(AxisType.Auto,) * 2)
    E.make_pod_mesh = lambda n, devices: Mesh(
        np.array(devices[:n]), ("pod",), axis_types=(AxisType.Auto,))
    out = sys.argv[1]
    rounds, k = 6, 5
    model = build_model(ModelConfig(name="el", family="dense", num_layers=2,
                                    d_model=128, num_heads=4, num_kv_heads=2,
                                    d_ff=256, vocab_size=512))
    edgc = EDGCConfig(policy="fixed", fixed_rank=8,
                      total_iterations=rounds * k,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=10, adjust_limit=4))
    tcfg = TrainerConfig(total_steps=rounds * k, log_every=1,
                         ckpt_path=out + "/st",
                         faults=parse_inject("nan_grad@7,pod_drop:1@r2,"
                                             "pod_join@r4"),
                         recovery=RecoveryConfig(rollback=False),
                         adam=AdamConfig(lr=1e-3, warmup_steps=5,
                                         total_steps=rounds * k))
    ocfg = OuterConfig(outer_k=k, policy="fixed", fixed_rank=8, window=2,
                       total_rounds=rounds, wire=sys.argv[2])
    et = E.ElasticTrainer(model, edgc, tcfg, ocfg, 2, lambda pod: SyntheticLM(
        512, 64, 4, seed=100 + pod).batches())
    et.save_checkpoint(out + "/r0")
    # the state an EF reset draws (the trainer's _comp_key), for the port
    lead = et.pods[0]
    fresh = init_compressor_state(lead.state["params"], lead.controller.plan,
                                  lead._comp_key, layout=lead._layout)
    reset = jax.device_get(replicate_comp_state(fresh, 1))
    np.savez(out + "/reset.npz", **{k + "|" + f: np.asarray(getattr(v, f))
                                    for k, v in reset.items()
                                    for f in ("q", "err")})
    hist = et.run_rounds(rounds)
    with open(out + "/hist.json", "w") as f:
        json.dump(hist, f)
    np.savez(out + "/anchor.npz",
             *[np.asarray(a) for a in jax.tree_util.tree_leaves(et.anchor)])
    print("REF_ELASTIC_OK")
""")


@pytest.fixture(scope="module", autouse=True)
def _ref_elastic_procs(tmp_path_factory):
    """The reference's runs of the parity schedule, raw and quant8, started
    together before the first test of the module."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    procs = {}
    for wire in ("raw", "quant8"):
        out = tmp_path_factory.mktemp(f"ref_{wire}")
        procs[wire] = (subprocess.Popen(
            [sys.executable, "-c", _REF_ELASTIC, str(out), wire], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture
def ref_elastic_runs(_ref_elastic_procs):
    def wait(wire):
        proc, out = _ref_elastic_procs[wire]
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REF_ELASTIC_OK" in stdout, \
            stdout[-3000:] + stderr[-3000:]
        return out
    return wait


@pytest.mark.parametrize("wire", ["raw", "quant8"])
def test_elastic_schedule_matches_reference_subprocess(tmp_path, monkeypatch,
                                                       ref_elastic_runs, wire):
    """``nan_grad@7,pod_drop:1@r2,pod_join@r4``, 6 rounds of K = 5, 2 pods,
    the outer wire raw and quant8 (the default): the port restores the
    reference's round-0 checkpoint and runs the reference's schedule. Pod
    counts [2, 2, 1, 1, 2, 2], the membership events, the recovery counters
    and each round's bytes are the reference's; pod losses within 5e-3.
    With the raw wire the final anchor is within rtol 1e-3 / atol 1e-4 of
    the reference's, element by element. Under quant8 outer payload codes
    flip at a quantizer boundary (fp32 factors summed in another order,
    ROADMAP Queue 3), and six rounds of Nesterov and Adam carry the moved
    elements on: each leaf of the final anchor is held within 5e-3 of the
    reference's in relative Frobenius norm (1.9e-3 at most when this test
    was written, with up to 15% of a block leaf's elements past the
    elementwise bar, by at most 4.6e-3)."""
    out = ref_elastic_runs(wire)
    ref_hist = json.loads((out / "hist.json").read_text())
    ref_anchor = np.load(out / "anchor.npz")
    reset_np = np.load(out / "reset.npz")
    keys = sorted({k.split("|")[0] for k in reset_np.files})
    from repro.core.powersgd import LowRankState as RefLowRankState
    reset = from_reference({"comp": {k: RefLowRankState(
        q=reset_np[k + "|q"], err=reset_np[k + "|err"]) for k in keys}})
    resets = []

    def ref_reset(self):
        resets.append(self._global_step)
        self.state = dict(self.state, comp=tree.tree_map(
            lambda a: a.clone(), reset["comp"]))
    monkeypatch.setattr(trainer_mod.Trainer, "_reset_comp_state", ref_reset)

    et = _port(tmp_path, 6, inject="nan_grad@7,pod_drop:1@r2,pod_join@r4",
               recovery=RecoveryConfig(rollback=False), wire=wire)
    assert et.restore_checkpoint(str(out / "r0")) == 0
    hist = et.run_rounds(6)
    assert [h["n_pods"] for h in hist] == [h["n_pods"] for h in ref_hist] \
        == [2, 2, 1, 1, 2, 2]
    assert [h["membership_events"] for h in hist] == \
        [h["membership_events"] for h in ref_hist]
    assert hist[2]["membership_events"] == ["pod_drop:1"]
    assert hist[4]["membership_events"] == ["pod_join"]
    assert len(resets) == 1
    for got, want in zip(hist, ref_hist):
        assert sorted(got) == sorted(want)
        for key in ("round", "bytes_synced", "bytes_full", "ranks",
                    "plan_changed") + (("bytes_wire_raw", "wire_bits")
                                       if wire != "raw" else ()):
            assert got[key] == want[key], key
        if wire == "quant8":
            assert (got["bytes_synced"], got["bytes_wire_raw"],
                    got["bytes_full"]) == (165132, 657920, 1706496)
        assert abs(got["entropy"] - want["entropy"]) < LOSS_TOL
        assert len(got["pod_losses"]) == len(want["pod_losses"])
        for a, b in zip(got["pod_losses"], want["pod_losses"]):
            assert abs(a - b) < LOSS_TOL, (got, want)
        rec, want_rec = dict(got["recovery"]), dict(want["recovery"])
        assert rec.pop("loss_ema") == pytest.approx(want_rec.pop("loss_ema"),
                                                    rel=LOSS_TOL)
        assert rec == want_rec
    assert hist[-1]["recovery"]["skipped_steps"] == 1
    assert hist[-1]["recovery"]["ef_resets"] == 1
    for got, name in zip(tree.leaves(et.anchor), ref_anchor.files):
        want = ref_anchor[name]
        got = got.numpy()
        if wire == "raw":
            _close(got, want)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel < 5e-3, (name, rel)


def test_composed_checkpoint_from_the_reference(tmp_path, monkeypatch):
    """A reference fleet (one pod, in this process) saves after two rounds;
    the port restores it (round index, anchor, outer state) and so does a
    second reference fleet; both run a third round: losses within 5e-3 and
    equal bytes."""
    _auto_meshes(monkeypatch)
    ref = _ref(tmp_path, 3)
    ref.run_rounds(2)
    ref.save_checkpoint(str(tmp_path / "ref_el"))
    et = _port(tmp_path, 3, n_pods=1)
    assert et.restore_checkpoint(str(tmp_path / "ref_el")) == 2
    assert et.outer.round_index == ref.outer.round_index == 2
    assert et.outer.state_dict()["bytes_synced"] == ref.outer.bytes_synced
    for got, want in zip(tree.leaves(et.anchor),
                         jax.tree_util.tree_leaves(ref.anchor)):
        _close(got, want, rtol=0, atol=0)
    ref_arrays = jax.device_get(ref.outer.arrays)
    for got, want in zip(tree.leaves(et.outer.arrays),
                         jax.tree_util.tree_leaves(ref_arrays)):
        _close(got, want, rtol=0, atol=0)
    # a restored fleet starts its pods' data streams afresh: the third
    # round is held to a reference fleet restored from the same files
    again = _ref(tmp_path, 3)
    assert again.restore_checkpoint(str(tmp_path / "ref_el")) == 2
    got, want = et.run_rounds(1)[-1], again.run_rounds(1)[-1]
    assert got["bytes_synced"] == want["bytes_synced"]
    assert abs(got["pod_losses"][0] - want["pod_losses"][0]) < LOSS_TOL


def test_composed_checkpoint_into_the_reference(tmp_path, monkeypatch):
    """The port's fleet (one pod) saves after two rounds; the reference
    restores it: the same round index, anchor and outer arrays."""
    _auto_meshes(monkeypatch)
    et = _port(tmp_path, 3, n_pods=1)
    et.run_rounds(2)
    et.save_checkpoint(str(tmp_path / "port_el"))
    ref = _ref(tmp_path, 3)
    assert ref.restore_checkpoint(str(tmp_path / "port_el")) == 2
    assert ref.outer.round_index == 2
    for got, want in zip(jax.tree_util.tree_leaves(ref.anchor),
                         tree.leaves(et.anchor)):
        _close(got, want, rtol=0, atol=0)
    for got, want in zip(jax.tree_util.tree_leaves(
            jax.device_get(ref.outer.arrays)), tree.leaves(et.outer.arrays)):
        _close(got, want, rtol=0, atol=0)


def test_restore_at_another_pod_count(tmp_path):
    """A two-pod checkpoint restored by a one-pod fleet rebuilds two pods,
    with the saved outer rows, and runs on."""
    et = _port(tmp_path, 4)
    et.run_rounds(2)
    et.save_checkpoint(str(tmp_path / "el"))
    back = _port(tmp_path, 4, n_pods=1)
    assert back.restore_checkpoint(str(tmp_path / "el")) == 2
    assert back.n_pods == back.outer.n_pods == 2
    for got, want in zip(tree.leaves(back.outer.arrays),
                         tree.leaves(et.outer.arrays)):
        assert torch.equal(got, want)
    hist = back.run_rounds(1)
    assert hist[-1]["n_pods"] == 2
    assert all(np.isfinite(hist[-1]["pod_losses"]))
    with pytest.raises(ValueError, match="2 pods"):
        _port(tmp_path, 4, n_pods=1, devices=["cpu"]).restore_checkpoint(
            str(tmp_path / "el"))


def test_pods_and_anchor_share_no_storage(tmp_path):
    """Under the donated step (no guard) every pod's parameters and the
    anchor are tensors of their own, before and after a round and across a
    drop and a join; the deltas are not zero."""
    et = _port(tmp_path, 4, inject="pod_drop:0@r1,pod_join@r2")
    for rnd in range(4):
        ptrs = _ptrs(et)
        assert len(set(ptrs)) == len(ptrs), rnd
        start = [a.clone() for a in tree.leaves(et.anchor)]
        h = et.run_rounds(1)[-1]
        assert all(not torch.equal(a, b)
                   for a, b in zip(start, tree.leaves(et.anchor)))
        for tr in et.pods:
            for a, b in zip(tree.leaves(tr.state["params"]),
                            tree.leaves(et.anchor)):
                assert torch.equal(a, b)
    assert [h["n_pods"] for h in et.history] == [2, 1, 2, 2]
    assert et.history[1]["membership_events"] == ["pod_drop:0"]


def test_bench_el_bytes_per_round(tmp_path):
    """``benchmarks/elastic_faults.py``'s fleet (bench-el, inner and outer
    policy fixed at rank 8, the default quant8 outer wire): each round
    moves 165132 coded bytes of 657920 raw and 1706496 uncompressed, the
    reference's numbers at this commit."""
    et = _port(tmp_path, 2, log_every=10)
    hist = et.run_rounds(2)
    for h in hist:
        assert (h["bytes_synced"], h["bytes_wire_raw"], h["bytes_full"]) == \
            (165132, 657920, 1706496)
    assert et.outer.comm_savings() == pytest.approx(1 - 165132 / 1706496)
    # with log_every > K a rebuilt pod has no logged step: NaN, as the
    # reference's (a round with a record has one)
    assert all(np.isfinite(h["pod_losses"]).all() for h in hist)


def test_launcher_outer_loop_and_report(tmp_path, capsys):
    """``--outer-k`` on the CPU: the round lines, the savings and recovery
    lines, the ``--out`` JSON, the telemetry's ``outer_round`` events and
    the report's elastic line, which the reference's report renders the
    same from the same records."""
    out = tmp_path / "el.json"
    hist = launch_train.main([
        "--arch", "gpt2", "--outer-k", "2", "--pods", "2", "--rounds", "3",
        "--outer-policy", "fixed", "--outer-rank", "8", "--batch", "2",
        "--seq", "16", "--inject", "pod_drop:1@r1,pod_join@r2", "--recover",
        "--ckpt-path", str(tmp_path / "ck"), "--metrics-dir",
        str(tmp_path / "m"), "--out", str(out), "--device", "cpu"])
    text = capsys.readouterr().out.splitlines()
    assert "elastic outer loop, 2 pods x K=2" in text[0]
    rounds = [line for line in text if line.startswith("round ")]
    assert len(rounds) == 3 and "['pod_drop:1']" in rounds[1] \
        and "['pod_join']" in rounds[2]
    assert any(line.startswith("outer comm savings vs raw fp32:")
               for line in text)
    assert any(line.startswith("recovery: {") for line in text)
    saved = json.loads(out.read_text())
    assert [h["n_pods"] for h in saved["history"]] == [2, 1, 2]
    assert saved["outer"]["outer_k"] == 2 and len(hist) == 3
    records = read_jsonl(str(tmp_path / "m" / "metrics.jsonl"))
    assert len([r for r in records if r["name"] == "outer_round"]) == 3
    lines = build_report(records)
    elastic = [x for x in lines if x.startswith("elastic:")]
    assert elastic == [x for x in ref_build_report(records)
                       if x.startswith("elastic:")]
    assert elastic[0].startswith("elastic: 3 outer rounds, final n_pods=2")
    timeline = [x for x in lines if "pod_drop" in x or "pod_join" in x]
    assert len(timeline) == 2


def test_launcher_refuses_outer_k_with_pipe():
    with pytest.raises(SystemExit, match="does not compose with --pipe"):
        launch_train.main(["--outer-k", "2", "--pipe", "2", "--device",
                           "cpu"])


def test_outer_loop_telemetry_is_pod_tagged(tmp_path):
    """One registry for the fleet: each pod's records carry its pod tag,
    and every round emits one ``outer_round`` event."""
    sink = MemorySink()
    et = _port(tmp_path, 2, metrics=MetricsRegistry([sink]))
    et.run_rounds(2)
    losses = [r for r in sink.of_kind("scalar") if r["name"] == "loss"]
    assert {r["pod"] for r in losses} == {0, 1}
    assert len(sink.events("outer_round")) == 2
