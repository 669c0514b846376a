"""The benchmark's counts of work and its metric arithmetic.

* ``flops.model_flops_per_token`` against torch's own counter
  (``torch.utils.flop_counter.FlopCounterMode``) on the reference's plain
  forward and backward with no recomputation, at tiny widths: equal.
* ``flops.shape_groups`` and ``flops.powersgd_work`` for the GPT-2 cell's
  three shape groups, worked out by hand.
* the interval arithmetic (union, overlap of a side stream, launches,
  percentile) on a trace recorded on a card
  (``record_trace_fixture.py``), against a brute-force sweep.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import catalog, flops, trace, weights
from bench.reference import model as ref_model

FIXTURE = Path(__file__).with_name("fixtures") / "two_streams.trace.json"


@pytest.mark.parametrize("cell", ["tiny-gpt2.flat.r64", "tiny-qwen.flat.r64"])
def test_model_flops_equal_torchs_counter(tiny_root, cell):
    m = catalog.cell(cell, tiny_root).model
    B, T = 2, 16
    u = {k: v.float().requires_grad_(True) for k, v in
         weights.units_of_flat(m, weights.make(m, 3, "cpu")).items()}
    tok = torch.randint(0, m["vocab_size"], (B, T))
    with FlopCounterMode(display=False) as counter:
        loss = ref_model.loss(m, u, tok, tok, remat=False)
        loss.backward()
    assert counter.get_total_flops() == flops.model_flops_per_token(m, T) * B * T


def test_gpt2_cell_groups_and_work_by_hand():
    m = catalog.cell("gpt2-2.5b.flat.r64").model
    groups = sorted((g.stack, g.m, g.n, g.rank) for g in flops.shape_groups(m, 64))
    assert groups == [(8, 1920, 7680, 64), (8, 7680, 1920, 64), (32, 1920, 1920, 64)]
    gs = flops.shape_groups(m, 64)
    mn = 32 * 1920 * 1920 + 2 * 8 * 1920 * 7680            # E m n summed
    f1, b1 = flops.powersgd_work(gs, param_bytes=2, world=1)
    # three products of 2 m n r, the EF add and the residual; orthonormalising
    # P costs 2 m r^2 a matrix
    assert f1 == mn * (6 * 64 + 2) + 2 * 64 * 64 * (32 * 1920 + 8 * 1920 + 8 * 7680)
    # G and g^ in bf16, E and E' in fp32, each once
    assert b1 == mn * (2 + 2 + 4 + 4) == 4_246_732_800
    # across cards the factors, r (m + n) fp32 numbers a matrix, go out and back
    _, b4 = flops.powersgd_work(gs, param_bytes=2, world=4)
    factors = 64 * (32 * (1920 + 1920) + 8 * (1920 + 7680) * 2)
    assert b4 - b1 == 2 * factors * 4
    assert flops.least_seconds(f1, b1) == pytest.approx(f1 / 67e12)


def test_matmul_params_of_both_configs():
    g = catalog.cell("gpt2-2.5b.flat.r64").model
    q = catalog.cell("qwen2.5-3b.flat.s4096").model
    assert flops.matmul_params(g) == 8 * (4 * 1920 ** 2 + 2 * 1920 * 7680) + 1920 * 50257
    assert flops.matmul_params(q) == (8 * (2 * 2048 ** 2 + 2 * 2048 * 256 + 3 * 2048 * 11008)
                                      + 2048 * 151936)


def _sweep(spans):
    """Covered length by a sweep over sorted endpoints with a depth count."""
    pts = sorted([(a, 1) for a, _ in spans] + [(b, -1) for _, b in spans])
    depth, last, total = 0, None, 0.0
    for x, d in pts:
        if depth > 0:
            total += x - last
        depth += d
        last = x
    return total


def test_interval_arithmetic_on_a_recorded_trace():
    with open(FIXTURE) as f:
        events = json.load(f)["traceEvents"]
    cap = trace.from_events(events, None, steps=6)
    ks = [(k.start, k.end) for k in cap.kernels]
    assert len(ks) >= 18
    assert trace.busy_us(cap) == pytest.approx(_sweep(trace.clip(ks, *cap.span)))
    side, over = trace.side_overlap(cap.kernels)
    by = trace.stream_time(cap.kernels)
    main = max(by, key=by.get)
    side_k = [(k.start, k.end) for k in cap.kernels if k.stream != main]
    main_k = [(k.start, k.end) for k in cap.kernels if k.stream == main]
    assert side == pytest.approx(sum(b - a for a, b in side_k))
    brute = sum(_sweep(main_k) + (b - a) - _sweep(main_k + [(a, b)]) for a, b in side_k)
    assert over == pytest.approx(brute)
    assert 0 < over <= side
    launches = [e for e in events if e["name"] in trace.LAUNCH_CALLS
                and cap.span[0] <= e["ts"] <= cap.span[1]]
    assert cap.launches == len(launches) > 0
    gaps = trace.idle_gaps(cap)
    assert sum(s for _, s in gaps) == pytest.approx((cap.window_us - trace.busy_us(cap)) / 1e6)
    assert trace.top_ops(cap)[0][1] == max(
        sum(k.end - k.start for k in cap.kernels if k.name == n) for n in {k.name for k in cap.kernels}) / 1e6


@pytest.mark.parametrize("q", [0, 10, 50, 90, 100])
def test_percentile_is_numpys(q):
    xs = list(np.random.default_rng(1).random(37) * 400)
    assert trace.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


@pytest.mark.cuda
def test_roofline_kernel_names_in_a_card_trace():
    """The PowerSGD kernels of the card appear in a profiler trace under the
    names ``kernels.powersgd_roofline`` reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the kernels are CUDA only")
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    mod = catalog.load_module("metrics", "kernels.powersgd_roofline")
    g = torch.randn(4, 512, 384, device="cuda")
    e = torch.zeros_like(g)
    q = torch.randn(4, 384, 64, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p = ops.orthonormalize3(ops.lowrank_p3(g, e, q))
        qn = ops.lowrank_q3(g, e, p)
        ops.decompress_residual3(p, qn, g, e)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    hits = {n for n in names if mod.KERNELS.search(n)}
    for part in ("ef_factor_kernel", "decompress_kernel", "gram_schmidt_kernel"):
        assert any(part in n for n in hits), sorted(names)
