"""Control-plane parity: the port's leaf classification, plans, byte ledgers,
rank bounds and CQM/DAC rank vectors equal the reference's exactly."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import GPT2_FIDELITY as REF_GPT2_FIDELITY
from repro.core import comm_model as ref_comm
from repro.core import compressor as ref_comp
from repro.core import controller as ref_ctrl
from repro.core.dac import DACConfig as RefDACConfig
from repro.core.entropy import GDSConfig as RefGDSConfig
from repro.models.model import build_model as ref_build_model
from repro.pipeline.sync import stage_wire_bytes as ref_stage_wire_bytes

from repro_torch.configs.gpt2 import GPT2_FIDELITY
from repro_torch.core import comm_model, compressor, controller
from repro_torch.core.dac import DACConfig
from repro_torch.core.entropy import GDSConfig
from repro_torch.models.model import build_model
from repro_torch.pipeline.sync import stage_wire_bytes

REF_HW = dataclasses.asdict(ref_comm.TPU_V5E)


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _leaf_sets(num_stages=4, min_dim=64):
    shapes = jax.eval_shape(ref_build_model(REF_GPT2_FIDELITY).init,
                            jax.random.PRNGKey(0))
    ref = ref_comp.classify_leaves(shapes, REF_GPT2_FIDELITY.num_layers,
                                   num_stages, min_dim=min_dim)
    params = build_model(GPT2_FIDELITY).init(0, "cpu")
    port = compressor.classify_leaves(params, GPT2_FIDELITY.num_layers,
                                      num_stages, min_dim=min_dim)
    return ref, port


@pytest.mark.parametrize("num_stages,min_dim", [(4, 64), (2, 64), (1, 128)])
def test_leaf_infos_equal(num_stages, min_dim):
    ref, port = _leaf_sets(num_stages, min_dim)
    assert [dataclasses.astuple(l) for l in port] == \
        [dataclasses.astuple(l) for l in ref]
    assert sum(l.eligible for l in port) >= 16


@pytest.mark.parametrize("policy,kw", [
    ("none", {}), ("fixed", {"fixed_rank": 8}), ("optimus", {"fixed_rank": 16}),
    ("edgc", {"stage_ranks": [12, 16, 20, 24]}),
])
def test_plans_and_wire_bytes_equal(policy, kw):
    ref, port = _leaf_sets()
    rp = ref_comp.make_plan(policy, ref, num_stages=4, **kw)
    pp = compressor.make_plan(policy, port, num_stages=4, **kw)
    assert pp.ranks == rp.ranks
    assert compressor.plan_wire_bytes(port, pp) == ref_comp.plan_wire_bytes(ref, rp)
    assert stage_wire_bytes(port, pp, 4) == ref_stage_wire_bytes(ref, rp, 4)


@pytest.mark.parametrize("world", [2, 16, 64])
def test_rank_bounds_equal(world):
    shapes = [(256, 1024)] * 8 + [(1024, 256)] * 8 + [(256, 256)] * 16
    ref = ref_comm.CommModel.from_shapes(shapes, world)
    port = comm_model.CommModel.from_shapes(
        shapes, world, hw=comm_model.HardwareSpec(**REF_HW))
    assert port.eta == ref.eta and port.overhead_per_rank == ref.overhead_per_rank
    for cap in (32, 128, 512):
        assert comm_model.rank_bounds(port, cap) == ref_comm.rank_bounds(ref, cap)
    # the port's own default is the H100 data sheet
    h100 = comm_model.CommModel.from_shapes(shapes, world)
    assert h100.hw.peak_flops == 989e12 and h100.hw.ici_bw == 450e9


def _controllers(policy):
    leaves_ref = [ref_comp.LeafInfo(
        path=f"['stages'][{s}]['blocks']['mlp']['up']", shape=(4, 512, 2048),
        stage=s, eligible=True) for s in range(4)] + [ref_comp.LeafInfo(
            path="['embed']['tok']", shape=(50257, 512), stage=0, eligible=False)]
    leaves_port = [compressor.LeafInfo(*dataclasses.astuple(l))
                   for l in leaves_ref]
    ref = ref_ctrl.EDGCController(ref_ctrl.EDGCConfig(
        policy=policy, num_stages=4, total_iterations=400,
        gds=RefGDSConfig(alpha=0.5, beta=0.25),
        dac=RefDACConfig(window=20, adjust_limit=4)), leaves_ref, world=16)
    port = controller.EDGCController(controller.EDGCConfig(
        policy=policy, num_stages=4, total_iterations=400,
        gds=GDSConfig(alpha=0.5, beta=0.25),
        dac=DACConfig(window=20, adjust_limit=4),
        hw=comm_model.HardwareSpec(**REF_HW)), leaves_port, world=16)
    return ref, port


@pytest.mark.parametrize("policy", ["edgc", "fixed", "optimus"])
@pytest.mark.parametrize("seed", [0, 1])
def test_controller_rank_vectors_equal(policy, seed):
    """The same entropy sequence drives both controllers through warm-up,
    CQM anchoring and DAC windows to the same rank vectors and plans."""
    ref, port = _controllers(policy)
    assert (port.r_min, port.r_max) == (ref.r_min, ref.r_max)
    rng = np.random.default_rng(seed)
    h = -4.0
    for step in range(400):
        if ref.wants_entropy(step):
            assert port.wants_entropy(step)
            reading = h + rng.normal() * 0.05
            ref.on_entropy(step, reading)
            port.on_entropy(step, reading)
        h -= 0.004
        if (step + 1) % 20 == 0:
            assert port.on_window_end(step) == ref.on_window_end(step)
            assert port.dac.current_ranks() == ref.dac.current_ranks()
            assert port.plan.ranks == ref.plan.ranks
    assert port.rank_history == ref.rank_history
    if policy == "edgc":
        assert port.rank_history, "warm-up never ended"
    assert port.describe() == ref.describe()


def test_tree_paths_match_reference_layout():
    """The port's init tree has the reference's keystr paths and shapes."""
    shapes = jax.eval_shape(ref_build_model(REF_GPT2_FIDELITY).init,
                            jax.random.PRNGKey(0))
    ref = [(jax.tree_util.keystr(kp), tuple(l.shape))
           for kp, l in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    from repro_torch import tree
    params = build_model(GPT2_FIDELITY).init(0, "cpu")
    port = [(p, tuple(t.shape)) for p, t in tree.flatten_with_path(params)]
    assert port == ref
    assert all(t.dtype == torch.float32 for t in tree.leaves(params))
