"""Fault specs, injectors and the controller fallback of the port against
the reference, on the same inputs: ``parse_inject`` events and errors,
``RecoveryState`` round trips, the torn-file injector, the element that
``poison_lowrank_state`` hits (raw and coded wire), and a controller
pinned to uncompressed sync, whose checkpoint state each package loads
from the other.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import EDGCConfig as RefEDGCConfig
from repro.core import comm_model as ref_comm
from repro.core.bucketing import make_bucket_layout as ref_make_bucket_layout
from repro.core.compressor import classify_leaves as ref_classify_leaves
from repro.core.compressor import init_compressor_state as ref_init_comp
from repro.core.compressor import make_plan as ref_make_plan
from repro.core.controller import EDGCController as RefController
from repro.models.model import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro.train import faults as ref_faults
from repro.train.step import replicate_comp_state as ref_replicate

from repro_torch import tree
from repro_torch.core import EDGCConfig, EDGCController, classify_leaves
from repro_torch.core.comm_model import HardwareSpec
from repro_torch.interop import from_reference
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.train import faults

TINY = dict(name="el", family="dense", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)

SPECS = ["nan_grad@40, corrupt_payload@8,pod_drop:1@r3",
         ["torn_ckpt@0", "pod_join@r12", "nan_grad@7"],
         "pod_drop@r2", "", " nan_grad@3 ,", "corrupt_payload:5@9"]
BAD = ["nan_grad", "explode@3", "pod_drop@3", "nan_grad@r3", "nan_grad@x",
       "pod_join:a@r1", "@5"]


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_parse_inject_matches_reference(spec):
    want = ref_faults.parse_inject(spec)
    got = faults.parse_inject(spec)
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]
    assert bool(got) == bool(want)
    for kind in faults.FAULT_KINDS:
        assert got.has(kind) == want.has(kind)
    for at in range(45):
        assert [dataclasses.astuple(e) for e in got.step_events(at)] == \
            [dataclasses.astuple(e) for e in want.step_events(at)]
        assert [dataclasses.astuple(e) for e in got.round_events(at)] == \
            [dataclasses.astuple(e) for e in want.round_events(at)]


@pytest.mark.parametrize("spec", BAD)
def test_parse_inject_refuses_as_reference(spec):
    with pytest.raises(ValueError) as want:
        ref_faults.parse_inject(spec)
    with pytest.raises(ValueError) as got:
        faults.parse_inject(spec)
    assert str(got.value) == str(want.value)


def test_recovery_config_and_state_match_reference():
    assert dataclasses.asdict(faults.RecoveryConfig()) == \
        dataclasses.asdict(ref_faults.RecoveryConfig())
    assert faults.FAULT_KINDS == ref_faults.FAULT_KINDS
    d = {"skipped_steps": 2, "ef_resets": 2, "rollbacks": 1, "anomalies": 3,
         "fallback": True, "loss_ema": 6.5, "backoff_until": 9,
         "unknown": 1}
    got = faults.RecoveryState.from_dict(d).as_dict()
    assert got == ref_faults.RecoveryState.from_dict(d).as_dict()
    assert faults.RecoveryState().as_dict() == \
        ref_faults.RecoveryState().as_dict()


@pytest.mark.parametrize("keep", [0.5, 0.3, 0.0])
def test_truncate_file_keeps_the_reference_bytes(tmp_path, keep):
    payload = bytes(range(256)) * 7
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_bytes(payload)
    b.write_bytes(payload)
    ref_faults.truncate_file(str(a), keep_frac=keep)
    faults.truncate_file(str(b), keep_frac=keep)
    assert a.read_bytes() == b.read_bytes() and os.path.getsize(b) >= 1


def _ref_comp(wire_ef: bool, bucketed: bool):
    """The reference's compressor state for TINY at fixed rank 8, with its
    leading replica dim, as numpy."""
    model = ref_build_model(RefModelConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0))
    leaves = ref_classify_leaves(params, TINY["num_layers"], 1, min_dim=64)
    plan = ref_make_plan("fixed", leaves, fixed_rank=8, num_stages=1)
    layout = ref_make_bucket_layout(leaves, plan) if bucketed else None
    comp = ref_init_comp(params, plan, jax.random.PRNGKey(7), layout=layout,
                         wire_ef=wire_ef)
    return jax.device_get(ref_replicate(comp, 1))


@pytest.mark.parametrize("wire_ef,bucketed", [(False, True), (True, True),
                                              (False, False)],
                         ids=["raw", "coded", "per-leaf"])
def test_poison_hits_the_reference_element(wire_ef, bucketed):
    host = _ref_comp(wire_ef, bucketed)
    port = from_reference({"comp": host})["comp"]
    ref_out = ref_faults.poison_lowrank_state(host)
    assert faults.poison_lowrank_state(port) is port
    want = jax.tree_util.tree_flatten_with_path(ref_out)[0]
    got = tree.flatten_with_path(port)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    hit = [p for p, leaf in got if torch.isnan(leaf).any()]
    assert len(hit) == 1
    for (path, leaf), (_, ref_leaf) in zip(got, want):
        np.testing.assert_array_equal(torch.isnan(leaf).numpy(),
                                      np.isnan(np.asarray(ref_leaf)[0]))
    first = hit[0]
    if wire_ef:
        assert first.startswith("[\"ef:")
    elif bucketed:
        assert first.startswith("['group:") and first.endswith(".q")
    else:
        assert first.endswith(".q")
    nan_at = torch.isnan(dict(got)[first]).reshape(-1).nonzero()
    assert nan_at.tolist() == [[0]]


def test_poison_refuses_without_float_state():
    with pytest.raises(ValueError, match="no float compressor state"):
        faults.poison_lowrank_state({})
    with pytest.raises(ValueError, match="no float compressor state"):
        faults.poison_lowrank_state({"n": torch.zeros(3, dtype=torch.int32)})


# ------------------------------------------------------ controller fallback
def _controllers(policy="fixed"):
    """Both controllers over TINY's leaves (fixed rank 8, the reference's
    TPU hardware numbers so that the rank bounds agree)."""
    model = ref_build_model(RefModelConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0))
    ref_leaves = ref_classify_leaves(params, TINY["num_layers"], 1,
                                     min_dim=64)
    ref = RefController(RefEDGCConfig(policy=policy, fixed_rank=8,
                                      total_iterations=20), ref_leaves,
                        world=1)
    port_params = build_model(ModelConfig(**TINY)).init(0, "cpu")
    leaves = classify_leaves(port_params, TINY["num_layers"], 1, min_dim=64)
    port = EDGCController(EDGCConfig(
        policy=policy, fixed_rank=8, total_iterations=20,
        hw=HardwareSpec(**dataclasses.asdict(ref_comm.TPU_V5E))), leaves,
        world=1)
    return ref, port


@pytest.mark.parametrize("policy", ["fixed", "edgc"])
def test_fallback_pins_uncompressed_as_reference(policy):
    ref, port = _controllers(policy)
    assert port.state_dict() == ref.state_dict()
    assert not port.in_fallback
    assert port.force_fallback() == ref.force_fallback() == (policy == "fixed")
    assert port.in_fallback and port.plan.ranks == ()
    assert port.force_fallback() is False        # already pinned
    ref.force_fallback()
    for step in (9, 19):
        port.on_entropy(step, 1.5)
        ref.on_entropy(step, 1.5)
        assert port.on_window_end(step) is ref.on_window_end(step) is False
    assert port.state_dict() == ref.state_dict()
    assert port.state_dict()["fallback"] is True


def test_each_package_loads_the_others_pinned_controller():
    """The checkpoint format's ``fallback`` flag round-trips both ways."""
    ref, port = _controllers()
    ref.force_fallback()
    fresh_ref, fresh_port = _controllers()
    fresh_port.load_state_dict(ref.state_dict())
    assert fresh_port.in_fallback and fresh_port.plan.ranks == ()
    assert fresh_port.state_dict() == ref.state_dict()
    port.force_fallback()
    fresh_ref.load_state_dict(port.state_dict())
    assert fresh_ref.in_fallback and fresh_ref.plan.ranks == ()
    assert fresh_ref.state_dict() == port.state_dict()
