"""Trainer parity under a coded wire: six steps of the port's Trainer
against the reference Trainer for ``wire`` quant8, quant4 and entropy, on
the same SyntheticLM batches and the same starting state (weights,
moments, warm-start Q and the ``ef:<path>`` residuals carried across by
``from_reference``). Per-step loss within 5e-3, the bar of the slice-1
trainer parity; ``bytes_synced`` and ``bytes_wire_raw`` equal; in entropy
mode the same bit width at every step. Fresh warm starts drawn at a DAC
re-plan come from each framework's own generator and are copied across.

The wire state is held too, one step at a time: a second port trainer
starts every step from the reference's state and its compressor state
after the step is held against the reference's (``_hold_wire_state``).

The reference runs on a 1 x 1 mesh built with Auto axes (``jax.make_mesh``
builds Explicit axes under jax 0.9, on which its embed gather raises).
"""
import dataclasses

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
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch.core import EDGCConfig, GDSConfig, SyncConfig
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


def ref_trainer(policy, wire, steps=STEPS, **tkw):
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    mesh = Mesh(devs, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    sync = RefSyncConfig(wire=wire)
    edgc = RefEDGCConfig(policy=policy, fixed_rank=8, num_stages=4,
                         total_iterations=steps,
                         gds=RefGDSConfig(alpha=0.5, beta=0.25),
                         dac=RefDACConfig(window=2, adjust_limit=4), sync=sync)
    tcfg = RefTrainerConfig(total_steps=steps, log_every=1, sync=sync,
                            adam=RefAdamConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=steps), **tkw)
    return RefTrainer(ref_build_model(RefModelConfig(**MODEL)), mesh, edgc,
                      tcfg, seed=0)


def port_trainer(policy, wire, steps=STEPS, **tkw):
    sync = SyncConfig(wire=wire)
    edgc = EDGCConfig(policy=policy, fixed_rank=8, num_stages=4,
                      total_iterations=steps,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=2, adjust_limit=4),
                      hw=HardwareSpec(**dataclasses.asdict(ref_comm.TPU_V5E)),
                      sync=sync)
    tcfg = TrainerConfig(total_steps=steps, log_every=1, sync=sync,
                         adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=steps), **tkw)
    return Trainer(build_model(ModelConfig(**MODEL)), edgc, tcfg, seed=0,
                   device="cpu")


def _hold_wire_state(comp, ref_comp, groups):
    """The port's compressor state after one step from the reference's
    state, against the reference's: every ``ef:<path>`` residual, and with
    ``groups`` every shape group's err and q, element by element at 1e-3 x
    max|array|.

    Codes can differ: the two gradients agree at the fp32 bar, but where a
    payload element straddles a rounding boundary of the quantizer its
    code moves by one, and that element's residual by one step. Such flips
    are allowed on at most 1e-4 of the ef elements (seen: at most 2e-5).
    A flipped factor element spreads through the orthonormalization into
    err and q, so those allow 2e-3 of the elements (seen: at most 6.2e-4,
    at rank 8). Coding switched off, or a step whose ef update is lost,
    moves nearly every ef element, and every ef entry must be non-zero.
    """
    want = from_reference({"comp": jax.device_get(ref_comp)})["comp"]
    assert sorted(comp) == sorted(want)
    off = {"ef": [0, 0], "group": [0, 0]}
    for key, st in comp.items():
        if key.startswith("ef:"):
            pairs, kind = [(st, want[key])], "ef"
            assert bool(want[key].abs().max() > 0), key
        elif groups:
            pairs, kind = [(st.err, want[key].err), (st.q, want[key].q)], "group"
        else:
            continue
        for got, ref_arr in pairs:
            assert got.dtype == ref_arr.dtype and got.shape == ref_arr.shape
            bar = 1e-3 * float(ref_arr.abs().max())
            off[kind][0] += int(((got - ref_arr).abs() > bar).sum())
            off[kind][1] += ref_arr.numel()
    assert off["ef"][1] and off["ef"][0] <= 1e-4 * off["ef"][1], off
    assert off["group"][0] <= 2e-3 * off["group"][1], off


@pytest.mark.parametrize("policy,wire", [("fixed", "quant8"),
                                         ("fixed", "quant4"),
                                         ("edgc", "entropy")])
def test_coded_trainer_parity_with_reference(policy, wire):
    ref = ref_trainer(policy, wire)
    port = port_trainer(policy, wire)
    assert port._codec == port.sync_cfg.codec
    assert (port._codec.bits, port._codec.group) == (ref._codec.bits,
                                                     ref._codec.group)
    port.state = from_reference(jax.device_get(ref.state))
    assert sorted(port.state["comp"]) == sorted(ref.state["comp"])
    assert any(k.startswith("ef:") for k in port.state["comp"])
    probe = port_trainer(policy, wire)
    ref_data = RefSyntheticLM(**DATA).batches()
    data = SyntheticLM(**DATA).batches()
    probe_data = SyntheticLM(**DATA).batches()
    bits = []
    for _ in range(STEPS):
        ranks = ref.controller.plan.ranks
        probe.state = from_reference(jax.device_get(ref.state))
        ref.run(ref_data, num_steps=1)
        port.run(data, num_steps=1)
        probe.run(probe_data, num_steps=1)
        for tr in (port, probe):
            assert tr.controller.plan.ranks == ref.controller.plan.ranks
            assert tr._codec.bits == ref._codec.bits
        bits.append(port._codec.bits)
        # a re-plan draws fresh warm starts; edgc's rank-64 groups spread a
        # flipped factor code over too many elements to hold them this way
        _hold_wire_state(probe.state["comp"], ref.state["comp"],
                         groups=policy == "fixed")
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
        assert got["bytes_wire_raw"] == want["bytes_wire_raw"]
        assert got["bytes_synced"] < got["bytes_wire_raw"]
        assert got["bytes_full"] == want["bytes_full"]
        assert got["stage_bytes"] == want["stage_bytes"]
    assert port.bytes_wire_raw == ref.bytes_wire_raw
    if policy == "edgc":
        assert port.history[-1]["ranks"]
    if wire != "entropy":
        assert bits == [{"quant8": 8, "quant4": 4}[wire]] * STEPS


@pytest.mark.parametrize("h0,h1", [(0.0, 0.0), (0.0, -1.0), (0.0, -1.5),
                                   (-2.0, -4.5), (-3.0, 1.0)])
def test_entropy_codec_refresh_matches_reference(h0, h1):
    """At a window end, entropy mode re-picks the width from the latest
    reading against the run's first: the same codec, and the same answer
    to "did it change", for readings on both sides of the 4-bit switch."""
    ref = ref_trainer("edgc", "entropy")
    port = port_trainer("edgc", "entropy")
    for tr in (ref, port):
        tr.controller.on_entropy(0, h0)
        tr._last_entropy = h1
    changed = port._refresh_codec()
    assert changed == ref._refresh_codec()
    assert (port._codec.bits, port._codec.group) == (ref._codec.bits,
                                                     ref._codec.group)
    assert port.sync_cfg.codec == port._codec
    assert port._price_plan() == ref._price_plan()
    assert port.stage_bytes() == ref.stage_bytes()
    for tr in (ref, port):
        tr._last_entropy = h0
    assert port._refresh_codec() == ref._refresh_codec()
    assert port._codec.bits == ref._codec.bits == 8


def test_raw_history_has_no_wire_ledger_and_per_leaf_coding_raises():
    port = port_trainer("fixed", "raw", steps=2)
    hist = port.run(SyntheticLM(**DATA).batches())
    assert all("bytes_wire_raw" not in h for h in hist)
    assert port.bytes_wire_raw == port.bytes_synced
    with pytest.raises(ValueError, match="bucketed"):
        port_trainer("fixed", "quant8", bucketed=False)
