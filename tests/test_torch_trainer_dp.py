"""The port's trainer outside the parity runs: two gloo workers on batch
halves against one worker on the whole batch, the command-line entry point on
the CPU, and the refusal to pick a device when CUDA is absent."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import EDGCConfig
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(name="t", family="dense", num_layers=4, d_model=128, num_heads=4,
             num_kv_heads=4, d_ff=256, vocab_size=512, norm="layernorm",
             act="gelu_plain", pos="learned", tie_embeddings=True,
             max_position=64, num_stages=4)
DATA = dict(vocab_size=512, seq_len=32, batch_size=4, seed=3)


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def test_trainer_without_cuda_or_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    edgc = EDGCConfig(policy="fixed", num_stages=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(build_model(ModelConfig(**MODEL)), edgc,
                TrainerConfig(total_steps=1), seed=0)


def test_launch_train_runs_on_cpu(capsys):
    from repro_torch.launch.train import main
    hist = main(["--arch", "gpt2", "--variant", "reduced", "--policy", "edgc",
                 "--steps", "4", "--window", "2", "--batch", "2", "--seq", "16",
                 "--device", "cpu"])
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    assert "final comm savings" in capsys.readouterr().out


# ------------------------------------------------- two workers under gloo
# One training run of the port: executed in this process (one worker on
# the whole batch) and in two gloo worker processes (one half each).
_DP_RUN = textwrap.dedent("""
    from repro_torch import tree
    from repro_torch.core import EDGCConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def run(model_kw, data_kw, steps=4):
        edgc = EDGCConfig(policy="fixed", fixed_rank=8, num_stages=4,
                          total_iterations=steps)
        tcfg = TrainerConfig(total_steps=steps, log_every=1,
                             adam=AdamConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=steps))
        tr = Trainer(build_model(ModelConfig(**model_kw)), edgc, tcfg,
                     seed=0, device="cpu")
        hist = tr.run(SyntheticLM(**data_kw).batches())
        return hist, [p.tolist() for p in tree.leaves(tr.state["params"])]
""")

_WORKER = _DP_RUN + textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    hist, params = run(*json.loads(sys.argv[4]))
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"hist": hist, "params": params}, f)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_workers_equal_one_worker_on_the_whole_batch(tmp_path):
    """Plain-mean sync and PowerSGD with EF are linear in the gradient up
    to the orthonormalisation of the mean, so two workers on batch halves
    reproduce one worker on the whole batch."""
    args = [MODEL, DATA]
    scope: dict = {}
    exec(_DP_RUN, scope)
    one_hist, one_params = scope["run"](*args)
    out = tmp_path / "two.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(port),
                               str(out), json.dumps(args)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    two = json.loads(out.read_text())
    assert [h["step"] for h in two["hist"]] == [h["step"] for h in one_hist]
    for a, b in zip(two["hist"], one_hist):
        assert abs(a["loss"] - b["loss"]) < 1e-4, (a, b)
        assert a["bytes_synced"] == b["bytes_synced"]
    for a, b in zip(two["params"], one_params):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3,
                                   atol=1e-4)


# ------------------------------------- recovery under two workers, the CLI
_FAULT_WORKER = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.core import EDGCConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.obs import MemorySink, MetricsRegistry
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.faults import RecoveryConfig, parse_inject
    from repro_torch.train.trainer import Trainer, TrainerConfig

    rank, port, out, ckpt = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                             sys.argv[4])
    model_kw, data_kw = json.loads(sys.argv[5])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    steps = 10
    sink = MemorySink()
    edgc = EDGCConfig(policy="fixed", fixed_rank=8, num_stages=4,
                      total_iterations=steps)
    tcfg = TrainerConfig(
        total_steps=steps, log_every=1, ckpt_every=3, ckpt_path=ckpt,
        faults=parse_inject("torn_ckpt@4,nan_grad@6"),
        recovery=RecoveryConfig(guard_nonfinite=False, ckpt_ring=2,
                                fallback_after=99),
        metrics=MetricsRegistry([sink]),
        adam=AdamConfig(lr=1e-3, warmup_steps=1, total_steps=steps))
    tr = Trainer(build_model(ModelConfig(**model_kw)), edgc, tcfg, seed=0,
                 device="cpu")
    hist = tr.run(SyntheticLM(**data_kw).batches())
    with open(f"{out}.{rank}", "w") as f:
        json.dump({"recovery": tr.recovery.as_dict(),
                   "loss": [h["loss"] for h in hist],
                   "events": [(e["name"], e["step"], e["data"])
                              for e in sink.events()],
                   "step": tr._global_step,
                   "params": [p.tolist()
                              for p in tree.leaves(tr.state["params"])]}, f)
    dist.destroy_process_group()
""")


def test_two_gloo_workers_roll_back_through_a_torn_checkpoint_alike(tmp_path):
    """Guard off, two workers: the save at ``_6`` is torn (worker 0 writes
    and tears it), the NaN of step 6 reaches the weights, and both workers
    read the pmean'd NaN loss at step 7, roll back past ``_6`` to ``_3``
    and replay to the end with the same counters and weights."""
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FAULT_WORKER, str(r), str(port), str(out),
         str(tmp_path / "st"), json.dumps([MODEL, DATA])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    runs = [json.loads((tmp_path / f"out.{r}").read_text()) for r in range(2)]
    for run in runs:
        assert run["recovery"]["rollbacks"] == 1 and run["step"] == 10
        assert ["rollback", 7, {"restored_step": 3}] in run["events"]
        assert np.isfinite(run["loss"][-1])
    assert runs[0]["recovery"] == runs[1]["recovery"]
    assert runs[0]["events"] == runs[1]["events"]
    assert runs[0]["loss"] == runs[1]["loss"]
    for a, b in zip(runs[0]["params"], runs[1]["params"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_launch_train_with_faults_then_report(tmp_path):
    """The command-line path: a run with an injected NaN gradient and the
    recovery policy writes its telemetry; the report command prints the
    guard skip in its timeline."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    mdir = tmp_path / "run"
    train = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gpt2",
         "--variant", "reduced", "--policy", "fixed", "--steps", "6",
         "--window", "2", "--batch", "2", "--seq", "16",
         "--inject", "nan_grad@3", "--recover", "--metrics-dir", str(mdir),
         "--out", str(tmp_path / "out.json"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert train.returncode == 0, train.stderr
    assert "recovery: {'skipped_steps': 1, 'ef_resets': 1" in train.stdout
    assert len(json.loads((tmp_path / "out.json").read_text())["history"]) == 6
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", str(mdir),
         "--csv", str(tmp_path / "m.csv")],
        env=env, capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0, rep.stderr
    lines = rep.stdout.splitlines()
    assert "fault/recovery timeline:" in lines
    assert "  step 3: guard_skip" in "\n".join(lines)
    assert "counter ef_resets: 1" in lines
    assert (tmp_path / "m.csv").exists()
