"""``correct`` comes out false when the timed path is broken underneath.

The harness runs a tiny cell on the CPU (the look for a card skipped: the
run is driven through ``harness.execute``), once clean and once with each
fault a training cell can have planted under the trainer: a step that
returns its state unchanged, half of each batch left out (the mean taken
over the rest), and, over two gloo processes, the DP exchange left out.
The control, the reference computed in fp8 in the program's place, must
fail the real cell's limits at a size a test can hold.
"""
from __future__ import annotations

import json

import pytest

from bench import catalog, faults, harness, synth, weights
from bench.reference import control as ref_control
from bench.reference import train as ref_train
from conftest import run_tiny
from test_bench_reference import run_dp


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["tiny-gpt2.flat.r64", "tiny-gpt2.pipe4.overlap"])
def test_fault_is_not_correct(tiny_root, cell, fault):
    clean = run_tiny(tiny_root, cell)
    broken = run_tiny(tiny_root, cell, fault=faults.FAULTS[fault])
    assert clean["correct"]
    assert not broken["correct"], broken["checks"]
    assert list(broken)[-1] == "checks"


def test_training_that_diverges_in_the_window_is_not_correct(tiny_root):
    """The first steps agree with the reference, the window's do not: the
    state the window leaves is not finite."""
    broken = run_tiny(tiny_root, "tiny-gpt2.flat.r64", fault=faults.FAULTS["diverges"])
    assert broken["checks"]["loss_gap"]["value"] <= broken["checks"]["loss_gap"]["limit"]
    assert broken["checks"]["window_nonfinite_tensors"]["value"] > 0
    assert not broken["correct"] and broken["failed"] > 0


def test_dp_exchange_left_out_is_not_correct(tiny_root, tmp_path):
    broken = run_dp(tiny_root, tmp_path, fault="no_exchange")
    assert not broken["correct"], broken["checks"]


@pytest.mark.parametrize("cell,tiny", [("gpt2-2.5b.flat.none", "tiny-gpt2-bf16.flat.none"),
                                       ("qwen2.5-3b.flat.s4096.none", "tiny-qwen-bf16.flat.none"),
                                       ("gpt2-2.5b.flat.r64", "tiny-gpt2-bf16.flat.r64"),
                                       ("qwen2.5-3b.flat.s4096", "tiny-qwen-bf16.flat.r64"),
                                       ("gpt2-2.5b.pipe4.overlap", "tiny-gpt2-bf16.flat.r64")])
def test_control_fails_the_cells_limits(tiny_root, cell, tiny):
    """The control at bf16 tiny widths (the mix's own Gram-Schmidt) against
    the fp32 reference, held to the real cell's limits."""
    import torch
    c = catalog.cell(tiny, tiny_root)
    c.mix = dict(c.mix, orthonormalisation=catalog.cell(cell).mix["orthonormalisation"])
    limits = catalog.cell(cell).limits
    seed = 2 ** 31 + 11
    u0 = {k: v.float() for k, v in weights.units_of_flat(
        c.model, weights.make(c.model, seed, "cpu")).items()}
    pool = synth.pool(c.model["vocab_size"], c.mix, seed, "cpu")[:harness.CHECK_STEPS]
    ref = ref_train.run(c.model, c.mix, u0, pool, seed)
    low = ref_train.run(c.model, c.mix, u0, pool, seed, mm=ref_control.fp8_matmul)
    checks = harness.compare(low, ref, limits)
    assert any(v["value"] > v["limit"] for v in checks.values()), json.dumps(checks)
    assert torch.isfinite(torch.tensor([v["value"] for v in checks.values()])).all()
