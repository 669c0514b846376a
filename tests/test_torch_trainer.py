"""Trainer parity: six steps of the port's Trainer against the reference
Trainer, step by step, on the same SyntheticLM batches and the same
starting state (weights, moments and warm-start Q carried across by
``from_reference``), for the none / fixed / optimus / edgc policies and
for the kernel path. Fresh warm starts drawn at a DAC re-plan come from
each framework's own generator, so they are copied across as well.

The reference runs on a 1 x 1 mesh built with Auto axes inside the test:
``jax.make_mesh`` builds Explicit axes under jax 0.9, on which the
reference's embed gather raises.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.core import EDGCConfig as RefEDGCConfig
from repro.core import GDSConfig as RefGDSConfig
from repro.core import comm_model as ref_comm
from repro.core.dac import DACConfig as RefDACConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.model import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch import tree
from repro_torch.core import EDGCConfig, GDSConfig
from repro_torch.core.comm_model import HardwareSpec
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import from_reference
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

STEPS = 6
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


def _edgc_kwargs(policy, rank, use_kernels):
    return dict(policy=policy, fixed_rank=rank, num_stages=4,
                total_iterations=STEPS, use_kernels=use_kernels)


def _ref_trainer(policy, rank, use_kernels):
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    mesh = Mesh(devs, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    edgc = RefEDGCConfig(gds=RefGDSConfig(alpha=0.5, beta=0.25),
                         dac=RefDACConfig(window=2, adjust_limit=4),
                         **_edgc_kwargs(policy, rank, use_kernels))
    tcfg = RefTrainerConfig(total_steps=STEPS, log_every=1,
                            use_kernels=use_kernels,
                            adam=RefAdamConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=STEPS))
    return RefTrainer(ref_build_model(RefModelConfig(**MODEL)), mesh, edgc,
                      tcfg, seed=0)


def _port_trainer(policy, rank, use_kernels, **model_kw):
    edgc = EDGCConfig(gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=2, adjust_limit=4),
                      hw=HardwareSpec(**dataclasses.asdict(ref_comm.TPU_V5E)),
                      **_edgc_kwargs(policy, rank, use_kernels))
    tcfg = TrainerConfig(total_steps=STEPS, log_every=1,
                         use_kernels=use_kernels,
                         adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=STEPS))
    return Trainer(build_model(ModelConfig(**{**MODEL, **model_kw})), edgc,
                   tcfg, seed=0, device="cpu")


@pytest.mark.parametrize("policy,rank,use_kernels", [
    ("none", 8, False), ("fixed", 8, False), ("optimus", 8, False),
    ("edgc", 8, False), ("fixed", 8, True)])
def test_trainer_parity_with_reference(policy, rank, use_kernels):
    ref = _ref_trainer(policy, rank, use_kernels)
    port = _port_trainer(policy, rank, use_kernels)
    assert port.leaves == [type(port.leaves[0])(*dataclasses.astuple(l))
                           for l in ref.leaves]
    port.state = from_reference(jax.device_get(ref.state))
    ref_data = RefSyntheticLM(**DATA).batches()
    data = SyntheticLM(**DATA).batches()
    for _ in range(STEPS):
        ranks = ref.controller.plan.ranks
        ref.run(ref_data, num_steps=1)
        port.run(data, num_steps=1)
        assert port.controller.plan.ranks == ref.controller.plan.ranks
        if ref.controller.plan.ranks != ranks:
            # fresh warm starts of the re-plan come from jax.random
            port.state["comp"] = from_reference(
                {"comp": jax.device_get(ref.state["comp"])})["comp"]
    assert len(port.history) == len(ref.history) == STEPS
    for got, want in zip(port.history, ref.history):
        assert got["step"] == want["step"]
        assert abs(got["loss"] - want["loss"]) < 5e-3, (got, want)
        assert got["ranks"] == want["ranks"]
        assert got["bytes_synced"] == want["bytes_synced"]
        assert got["bytes_full"] == want["bytes_full"]
        assert got["stage_bytes"] == want["stage_bytes"]
        assert np.isclose(got["lr"], want["lr"], rtol=1e-6)
    assert port.comm_savings() == pytest.approx(ref.comm_savings(), abs=1e-12)
    if policy == "edgc":
        assert port.history[0]["ranks"] == [] and port.history[-1]["ranks"]
    # the synced step moved the weights the same way
    ref_params = jax.tree_util.tree_leaves(jax.device_get(ref.state["params"]))
    for got, want in zip(tree.leaves(port.state["params"]), ref_params):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)
