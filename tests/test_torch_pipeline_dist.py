"""The port's pipelined trainer across processes and checkpoints: the
reference's S = 4 pipelined trainer in a subprocess, the two pipe
transports in two gloo processes, and a pipelined checkpoint resumed.

The reference runs on four fake CPU devices in one subprocess, on a mesh
with a ``pipe`` axis built by hand with Auto axes (``jax.make_mesh``
builds Explicit axes under jax 0.9, on which the reference's embed gather
raises). It hands back its losses in an ``.npz`` beside a checkpoint of
its starting state in the shared format, which the port restores (weights
and warm starts: the warm starts come from ``jax.random`` there).

Bars: losses within 5e-3 of the reference's (``test_torch_trainer.py``'s
bar), entropy within 1e-4, ``bytes_synced`` equal; the two transports, and
a resumed run against the unbroken one, within 1e-6.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import EDGCConfig, GDSConfig
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.pipeline.executor import DistPipe, LocalPipe, host_state
from repro_torch.train.step import TrainStepConfig, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
DATA = dict(vocab_size=512, seq_len=32, batch_size=8, seed=3)


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _port(S, micro, steps=STEPS, layers=4, stash="replay", **tkw):
    """The port's pipelined trainer on the CPU, fixed rank 8 (the model and
    run of the reference subprocess below)."""
    cfg = ModelConfig(name="pp", family="dense", num_layers=layers,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=512, num_stages=S)
    return Trainer(
        build_model(cfg),
        EDGCConfig(policy="fixed", fixed_rank=8, num_stages=S,
                   total_iterations=steps, gds=GDSConfig(alpha=0.5, beta=0.25),
                   dac=DACConfig(window=3, adjust_limit=4)),
        TrainerConfig(total_steps=steps, log_every=1, schedule="1f1b",
                      num_microbatches=micro, stash_policy=stash,
                      adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                      total_steps=steps), **tkw),
        seed=0, device="cpu", pipe=S)


_REF_S4 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import AxisType, Mesh
    from repro.core import EDGCConfig, GDSConfig
    from repro.core.dac import DACConfig
    from repro.data.pipeline import SyntheticLM
    from repro.models.model import ModelConfig, build_model
    from repro.optim.adam import AdamConfig
    from repro.train.trainer import Trainer, TrainerConfig

    out = sys.argv[1]
    steps = 4
    devs = np.array(jax.devices()[:4]).reshape(4, 1, 1)
    mesh = Mesh(devs, ("pipe", "data", "model"),
                axis_types=(AxisType.Auto,) * 3)
    cfg = ModelConfig(name="pp", family="dense", num_layers=4, d_model=128,
                      num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
                      num_stages=4)
    edgc = EDGCConfig(policy="fixed", fixed_rank=8, num_stages=4,
                      total_iterations=steps,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=3, adjust_limit=4))
    tcfg = TrainerConfig(total_steps=steps, log_every=1, schedule="1f1b",
                         num_microbatches=4,
                         adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=steps))
    tr = Trainer(build_model(cfg), mesh, edgc, tcfg, seed=0)
    tr.save_checkpoint(out + "/start", step=0)
    hist = tr.run(SyntheticLM(512, 32, 8, seed=3).batches())
    np.savez(out + "/ref.npz",
             loss=np.array([h["loss"] for h in hist]),
             entropy=np.array([h["entropy"] for h in hist]),
             bytes_synced=np.array([h["bytes_synced"] for h in hist]),
             stage_bytes=np.array([h["stage_bytes"] for h in hist]))
    print("REF_S4_OK")
""")


def test_pipelined_trainer_s4_equals_reference_subprocess(tmp_path):
    """S = 4, M = 4, 1F1B, fixed rank 8: the reference on four fake
    devices in a subprocess; the port restores the reference's starting
    checkpoint (pipelined state, (S, W, ...) compressor leaves) and runs
    the same four steps with its four stage programs in this process."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF_S4, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "REF_S4_OK" in proc.stdout, \
        proc.stdout[-3000:] + proc.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    port = _port(4, micro=4)
    assert port.restore_checkpoint(str(tmp_path / "start")) == 0
    hist = port.run(SyntheticLM(**DATA).batches())
    assert len(hist) == STEPS
    for h, loss, ent, b, sb in zip(hist, ref["loss"], ref["entropy"],
                                   ref["bytes_synced"], ref["stage_bytes"]):
        assert abs(h["loss"] - loss) < 5e-3, (h, loss)
        assert abs(h["entropy"] - ent) < 1e-4, (h, ent)
        assert h["bytes_synced"] == b
        assert [list(x) for x in h["stage_bytes"]] == sb.tolist()


# ------------------------------------------------ the two transports
_DIST = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    from test_torch_pipeline_dist import _transport_run
    from repro_torch.pipeline.executor import DistPipe
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    mets, params = _transport_run(DistPipe(2))
    with open(f"{out}.{rank}", "w") as f:
        json.dump({"mets": mets, "params": params}, f)
    dist.destroy_process_group()
""")


def _transport_run(pipe, steps=3):
    """Three pipelined steps at S = 2 (3 layers: a ragged plan, every_k
    stash, M = 4) on the stages ``pipe`` hosts, from the trainer's state."""
    tr = _port(2, micro=4, stash="every_k", steps=steps, layers=3)
    scfg = TrainStepConfig(policy_plan=tr.controller.plan, gds=tr.edgc_cfg.gds,
                           pipeline=tr.pipeline_cfg, sync=tr.sync_cfg,
                           adam=tr.tcfg.adam, remat=False)
    step = make_train_step(tr.model, scfg, psum_mean=lambda x: x, pipe=pipe)
    state = host_state(tr.state, pipe.stages)
    data = SyntheticLM(**DATA).batches()
    mets = []
    for _ in range(steps):
        batch = {k: torch.as_tensor(v).long() for k, v in next(data).items()}
        state, m = step(state, batch)
        mets.append([float(m[k]) for k in ("loss", "entropy", "grad_norm",
                                           "ef_norm")]
                    + m["stage_entropy"].tolist())
    return mets, [p.tolist() for p in tree.leaves(state["stage_params"])]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dist_pipe_two_gloo_processes_equal_local_pipe(tmp_path):
    """One stage per gloo process (point-to-point sends, an all-reduce on
    the pipe group) against both stages in one process."""
    mets, params = _transport_run(LocalPipe(2))
    out = tmp_path / "dist"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _DIST, str(r), str(port),
                               str(out), os.path.join(ROOT, "tests")],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    for r in range(2):
        got = json.loads((tmp_path / f"dist.{r}").read_text())
        np.testing.assert_allclose(got["mets"], mets, rtol=0, atol=1e-6)
        for a, b in zip(got["params"], params, strict=True):
            np.testing.assert_allclose(np.asarray(a)[0], np.asarray(b)[r],
                                       rtol=0, atol=1e-6)


# ------------------------------------------------ checkpoints
def test_pipelined_checkpoint_save_restore_resume(tmp_path):
    """A pipelined run saved at step 3 and resumed in a fresh trainer
    continues exactly as the unbroken run; the archive holds the
    reference's layout ((S, W, ...) compressor leaves)."""
    path = str(tmp_path / "run")
    full = _port(2, micro=4, steps=6, ckpt_every=3, ckpt_path=path)
    hist = full.run(SyntheticLM(**DATA).batches())
    names = json.loads(open(path + "_3.json").read())["names"]
    with np.load(path + "_3.npz") as z:
        comp = [i for i, n in enumerate(names) if n.startswith("['comp']")]
        assert comp and all(z[f"leaf_{i}"].shape[:2] == (2, 1) for i in comp)
        stage = [i for i, n in enumerate(names)
                 if n.startswith("['stage_params']")]
        assert stage and all(z[f"leaf_{i}"].shape[:2] == (2, 2)
                             for i in stage)
    resumed = _port(2, micro=4, steps=6)
    assert resumed.restore_checkpoint(path + "_3") == 3
    data = SyntheticLM(**DATA).batches()
    for _ in range(3):
        next(data)
    rest = resumed.run(data)
    for a, b in zip(rest, hist[3:], strict=True):
        assert a["step"] == b["step"]
        assert abs(a["loss"] - b["loss"]) < 1e-6, (a, b)
        assert a["bytes_synced"] == b["bytes_synced"]
    for a, b in zip(tree.leaves(resumed.state), tree.leaves(full.state)):
        assert torch.equal(a, b)


