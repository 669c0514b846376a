"""Checkpoints of the port: a run saved mid-way and restored into a fresh
Trainer continues as the run that never stopped (coded wires included);
torn pairs raise ``CheckpointError``; and the format is the reference's,
so the port continues a run the reference saved (within the 5e-3 loss bar
of the trainer parity) and the reference continues one the port saved.
Under two gloo workers, each gets its own compressor state back.

The reference runs on a 1 x 1 mesh built with Auto axes (``jax.make_mesh``
builds Explicit axes under jax 0.9, on which its embed gather raises).
"""
import dataclasses
import os
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs.gpt2 import GPT2_FIDELITY as REF_GPT2_FIDELITY
from repro.core import EDGCConfig as RefEDGCConfig
from repro.core import GDSConfig as RefGDSConfig
from repro.core import SyncConfig as RefSyncConfig
from repro.core import comm_model as ref_comm
from repro.core.dac import DACConfig as RefDACConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.model import build_model as ref_build_model
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch import tree
from repro_torch.configs.gpt2 import GPT2_FIDELITY
from repro_torch.core import EDGCConfig, GDSConfig, SyncConfig
from repro_torch.core.comm_model import HardwareSpec
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import from_reference
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer, TrainerConfig

STEPS = 6
MODEL = dict(name="t", family="dense", num_layers=4, d_model=128, num_heads=4,
             num_kv_heads=4, d_ff=256, vocab_size=512, norm="layernorm",
             act="gelu_plain", pos="learned", tie_embeddings=True,
             max_position=64, num_stages=4)
DATA = dict(vocab_size=512, seq_len=32, batch_size=4, seed=3)
FID_DATA = dict(vocab_size=GPT2_FIDELITY.vocab_size, seq_len=32, batch_size=4,
                seed=5)


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _port(policy, wire, model_cfg, **tkw):
    sync = SyncConfig(wire=wire)
    edgc = EDGCConfig(policy=policy, fixed_rank=8, num_stages=4,
                      total_iterations=STEPS,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=2, adjust_limit=4),
                      hw=HardwareSpec(**dataclasses.asdict(ref_comm.TPU_V5E)),
                      sync=sync)
    tcfg = TrainerConfig(total_steps=STEPS, log_every=1, sync=sync,
                         adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=STEPS), **tkw)
    return Trainer(build_model(model_cfg), edgc, tcfg, seed=0, device="cpu")


def _ref(**tkw):
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    mesh = Mesh(devs, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    sync = RefSyncConfig(wire="raw")
    edgc = RefEDGCConfig(policy="fixed", fixed_rank=8, num_stages=4,
                         total_iterations=STEPS,
                         gds=RefGDSConfig(alpha=0.5, beta=0.25),
                         dac=RefDACConfig(window=2, adjust_limit=4), sync=sync)
    tcfg = RefTrainerConfig(total_steps=STEPS, log_every=1, sync=sync,
                            adam=RefAdamConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=STEPS), **tkw)
    return RefTrainer(ref_build_model(REF_GPT2_FIDELITY), mesh, edgc, tcfg,
                      seed=0)


def _from(batches, skip):
    for _ in range(skip):
        next(batches)
    return batches


@pytest.mark.parametrize("policy,wire", [("fixed", "quant8"),
                                         ("edgc", "entropy")])
def test_resumed_run_continues_like_the_unbroken_run(tmp_path, policy, wire):
    """Saved at step 3 (mid-window for edgc: the DAC's partial window, the
    entropy history and the ef:<path> residuals all ride in the pair) and
    restored into a fresh Trainer: the same losses, ranks, bit widths and
    byte ledgers as the run that went on. Both runs compute the same
    thing on the same device, so the losses agree to 1e-6."""
    path = str(tmp_path / "run")
    whole = _port(policy, wire, ModelConfig(**MODEL), ckpt_every=3,
                  ckpt_path=path)
    hist = whole.run(SyntheticLM(**DATA).batches())
    assert os.path.exists(path + "_3.npz") and os.path.exists(path + "_6.json")
    resumed = _port(policy, wire, ModelConfig(**MODEL))
    assert resumed.restore_checkpoint(path + "_3") == 3
    assert any(k.startswith("ef:") for k in resumed.state["comp"])
    rest = resumed.run(_from(SyntheticLM(**DATA).batches(), 3))
    assert [h["step"] for h in rest] == [3, 4, 5]
    for got, want in zip(rest, hist[3:]):
        assert abs(got["loss"] - want["loss"]) <= 1e-6, (got, want)
        for key in ("ranks", "bytes_synced", "bytes_wire_raw", "bytes_full",
                    "stage_bytes"):
            assert got[key] == want[key], key
    assert resumed._codec == whole._codec
    assert resumed.controller.state_dict() == whole.controller.state_dict()
    for a, b in zip(tree.leaves(resumed.state), tree.leaves(whole.state)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_torn_pairs_raise(tmp_path):
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "b": [torch.ones(4, dtype=torch.bfloat16),
                   torch.zeros((), dtype=torch.int32)]}
    p1, p2 = str(tmp_path / "one"), str(tmp_path / "two")
    ckpt.save(p1, state, extra={"step": 1})
    ckpt.save(p2, state, extra={"step": 2})
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no leaf is coerced
        got, extra = ckpt.restore(p1, state)
    assert extra == {"step": 1} and ckpt.read_extra(p2) == {"step": 2}
    for a, b in zip(tree.leaves(got), tree.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # archive of one save beside the manifest of another: same size,
    # different nonce
    shutil.copy(p2 + ".npz", p1 + ".npz")
    with pytest.raises(ckpt.CheckpointError, match="nonce mismatch"):
        ckpt.restore(p1, state)
    with open(p2 + ".npz", "r+b") as f:       # a write cut short
        f.truncate(os.path.getsize(p2 + ".npz") // 2)
    with pytest.raises(ckpt.CheckpointError, match="truncated"):
        ckpt.restore(p2, state)
    os.remove(p2 + ".npz")
    with pytest.raises(ckpt.CheckpointError, match="missing"):
        ckpt.restore(p2, state)
    with pytest.raises(ckpt.CheckpointError, match="no checkpoint manifest"):
        ckpt.read_extra(str(tmp_path / "none"))
    ckpt.save(p1, state)
    with pytest.raises(ckpt.CheckpointError, match="structure mismatch"):
        ckpt.restore(p1, {"a": state["a"]})
    with pytest.raises(ckpt.CheckpointError, match="shape mismatch"):
        ckpt.restore(p1, dict(state, a=torch.zeros(3, 2)))
    with pytest.warns(UserWarning, match="dtype mismatch"):
        got, _ = ckpt.restore(p1, dict(state, a=state["a"].double()))
    assert got["a"].dtype == torch.float64


def test_checkpoints_cross_between_the_packages(tmp_path):
    """gpt2-fidelity, fp32, raw wire, fixed rank 8. The reference saves at
    step 3 and goes on; the port restores its pair and continues within
    5e-3 of the reference's own continuation. The port, started from the
    reference's initial state, saves at step 3 too, and the reference
    continues the port's pair within the same bar."""
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = _ref(ckpt_every=3, ckpt_path=ref_path)
    init = jax.device_get(ref.state)
    ref_hist = ref.run(RefSyntheticLM(**FID_DATA).batches())

    port = _port("fixed", "raw", GPT2_FIDELITY)
    assert port.restore_checkpoint(ref_path + "_3") == 3
    rest = port.run(_from(SyntheticLM(**FID_DATA).batches(), 3))
    for got, want in zip(rest, ref_hist[3:], strict=True):
        assert got["step"] == want["step"]
        assert abs(got["loss"] - want["loss"]) < 5e-3, (got, want)
        assert got["bytes_synced"] == want["bytes_synced"]
        assert got["bytes_full"] == want["bytes_full"]

    port = _port("fixed", "raw", GPT2_FIDELITY, ckpt_every=3,
                 ckpt_path=port_path)
    port.state = from_reference(init)
    port_hist = port.run(SyntheticLM(**FID_DATA).batches())
    back = _ref()
    assert back.restore_checkpoint(port_path + "_3") == 3
    back_hist = back.run(_from(RefSyntheticLM(**FID_DATA).batches(), 3))
    for got, want in zip(back_hist, port_hist[3:], strict=True):
        assert got["step"] == want["step"]
        assert abs(got["loss"] - want["loss"]) < 5e-3, (got, want)
        assert got["bytes_synced"] == want["bytes_synced"]


# --------------------------------------------- two workers under gloo
_DP_WORKER = """
import json, sys
import torch
import torch.distributed as dist
from repro_torch import tree
from repro_torch.core import EDGCConfig, SyncConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

rank, port, out, model_kw, data_kw = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], *map(json.loads, sys.argv[4:6]))
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)

def trainer(**kw):
    sync = SyncConfig(wire="quant8")
    edgc = EDGCConfig(policy="fixed", fixed_rank=8, num_stages=4,
                      total_iterations=4, sync=sync)
    tcfg = TrainerConfig(total_steps=4, log_every=1, sync=sync,
                         adam=AdamConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=4), **kw)
    return Trainer(build_model(ModelConfig(**model_kw)), edgc, tcfg, seed=0,
                   device="cpu")

whole = trainer(ckpt_every=2, ckpt_path=out + "/run")
batches = SyntheticLM(**data_kw).batches()
whole.run(batches, num_steps=2)
snap = [t.clone() for t in tree.leaves(whole.state["comp"])]
hist = whole.run(batches)
resumed = trainer()
resumed.restore_checkpoint(out + "/run_2")
same = all(torch.equal(a, b) for a, b in
           zip(tree.leaves(resumed.state["comp"]), snap))
later = SyntheticLM(**data_kw).batches()
next(later), next(later)
rest = resumed.run(later)
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump({"hist": [h["loss"] for h in hist], "rest": [h["loss"] for h in rest],
               "same_comp": same,
               "ef": float(sum(t.abs().sum() for k, t in
                               whole.state["comp"].items() if k.startswith("ef:")))}, f)
dist.destroy_process_group()
"""


def test_two_gloo_workers_save_and_resume_their_own_state(tmp_path):
    """Each worker's compressor state (its own EF, which differs between
    workers on different batch halves) is gathered into one pair by worker
    0 and comes back to its own worker on restore: the resumed runs
    continue as the unbroken one, coded sync over gloo included."""
    import json
    import socket
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_WORKER, str(r), str(port), str(tmp_path),
         json.dumps(MODEL), json.dumps(DATA)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]
    for r in res:
        assert r["same_comp"]
        np.testing.assert_allclose(r["rest"], r["hist"][2:], rtol=0, atol=1e-6)
    assert res[0]["hist"] == res[1]["hist"]
    assert res[0]["ef"] != res[1]["ef"]          # per-worker residuals
    with np.load(tmp_path / "run_2.npz") as data:
        names = json.loads((tmp_path / "run_2.json").read_text())["names"]
        ef = [i for i, n in enumerate(names) if n.startswith("['comp'][\"ef:")]
        assert ef and all(data[f"leaf_{i}"].shape[0] == 2 for i in ef)
