"""xLSTM and Mamba2 parity: the port's ``models/ssm.py``, its
``XLSTMAdapter`` and its trainers against the reference's, on the reduced
configs and ``tests/test_pipeline.py``'s ``FAMILY_CFGS``, with inputs from
numpy seeds and the reference's weights carried across.

Bars: the chunked recurrence at rtol 1e-5; every block's forward at rtol
1e-5 and its gradients at rtol 1e-4, atol 1e-6; the model's fp32 loss at
rtol 1e-5 and gradients at rtol 1e-4 (``test_torch_model.py``'s), each
leaf's atol 1e-5 of its largest gradient (at least 1e-6); bf16 logits
within 1e-2 relative; trainer losses within 5e-3
(``tests/test_pipeline.py:553``'s) with equal bytes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ssm as ref_ssm
from repro.pipeline import partition as ref_part

from _torch_families import (  # noqa: F401  (the autouse fixture)
    assert_close, batches, bf16_forward_matches, block_grads_match,
    block_params, check_history,
    family_data, loss_and_grads_match, pair, port_config, port_trainer,
    ref_trainer, small_torch_thread_pool)
from test_pipeline import FAMILY_CFGS

from repro_torch import tree
from repro_torch.interop import from_reference, to_tensor
from repro_torch.models import hybrid, ssm
from repro_torch.pipeline import partition as part_mod
from repro_torch.pipeline.adapters import XLSTMAdapter, supported_reason

ARCH = "xlstm-125m"


def _recurrence_inputs(T, H=3, Dk=16, Dv=17, B=2, log_a=None, seed=0):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, T, H, Dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, T, H, Dv)).astype(np.float32)
    la = (-np.abs(rng.standard_normal((B, T, H))).astype(np.float32) * 0.3
          if log_a is None else np.full((B, T, H), log_a, np.float32))
    return q, k, v, la


@pytest.mark.parametrize("T,chunk,with_s0", [
    (64, 16, False), (64, 16, True), (64, 32, False), (48, 48, True),
    (64, 64, False), (32, 8, True)])
def test_chunked_recurrence_matches_reference(T, chunk, with_s0):
    q, k, v, la = _recurrence_inputs(T)
    s0 = (np.random.default_rng(1).standard_normal((2, 3, 16, 17))
          .astype(np.float32) if with_s0 else None)
    want_y, want_s = ref_ssm.chunked_linear_recurrence(
        *map(jnp.asarray, (q, k, v, la)), chunk,
        None if s0 is None else jnp.asarray(s0))
    y, s = ssm.chunked_linear_recurrence(
        *map(torch.from_numpy, (q, k, v, la)), chunk,
        None if s0 is None else torch.from_numpy(s0))
    assert y.dtype == s.dtype == torch.float32
    assert_close(y, want_y, rtol=1e-5, atol=1e-6)
    assert_close(s, want_s, rtol=1e-5, atol=1e-6)


def test_decay_overflow_gives_both_packages_the_same_nonfinite_grads():
    """At log a = -8 a chunk of 32 sums past 88: exp of the masked upper
    triangle overflows before the mask, and the backward multiplies inf by
    zero. The forward stays finite; the gradients are non-finite at the
    same elements in both packages (the reference's defect, kept)."""
    q, k, v, la = _recurrence_inputs(64, log_a=-8.0)
    ct = np.random.default_rng(2).standard_normal((2, 64, 3, 17)).astype(
        np.float32)
    f = lambda *a: ref_ssm.chunked_linear_recurrence(*a, 32)[0]
    want_y, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v, la)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, la)]
    y, _ = ssm.chunked_linear_recurrence(*xs, 32)
    got = [g.numpy() for g in torch.autograd.grad(y, xs, torch.from_numpy(ct))]
    assert np.isfinite(np.asarray(want_y)).all()
    assert torch.isfinite(y).all()
    assert_close(y, want_y, rtol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    # the NaN enters through the decay, so it reaches log a alone
    assert [bool(np.isfinite(w).all()) for w in want] == [True, True, True,
                                                         False]
    assert np.isnan(want[3]).any()


@pytest.mark.parametrize("T", [5, 24])
def test_causal_conv_matches_reference(T):
    cfg = ref_get_config(ARCH, "reduced")
    p_np = jax.device_get(ref_ssm.causal_conv_init(
        jax.random.PRNGKey(1), 32, cfg.conv_kernel, jnp.float32))
    p_np = dict(p_np, b=np.linspace(-1, 1, 32).astype(np.float32))
    x_np = np.random.default_rng(3).standard_normal((2, T, 32)).astype(
        np.float32)
    block_grads_match(lambda p, x, c: ref_ssm.causal_conv_apply(p, x),
                      lambda p, x, c: ssm.causal_conv_apply(p, x), None, None,
                      p_np, tree.tree_map(to_tensor, p_np), x_np)


@pytest.mark.parametrize("block,arch", [("mlstm", ARCH), ("slstm", ARCH),
                                        ("mamba2", "zamba2-7b")])
@pytest.mark.parametrize("T", [16, 24])
def test_blocks_forward_and_grads_match_reference(block, arch, T):
    """mLSTM (with the normaliser channel), sLSTM (the sequential loop) and
    Mamba2 (heads of 64, B and C shared): T = 24 pads to the chunk."""
    ref_cfg = ref_get_config(arch, "reduced")
    cfg = port_config(ref_cfg)
    p_np, p = block_params(getattr(ref_ssm, f"{block}_init"), 4, ref_cfg)
    x_np = np.random.default_rng(6).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    block_grads_match(getattr(ref_ssm, f"{block}_apply"),
                      getattr(ssm, f"{block}_apply"), ref_cfg, cfg, p_np, p,
                      x_np)


def test_fp32_leaves_stay_fp32_in_bf16_models():
    """gate_bias, a_log, dt_bias and d_skip are fp32 under bf16 weights, in
    the port's init and in the reference's weights ``from_reference``
    carries across."""
    for arch in (ARCH, "zamba2-7b"):
        cfg = port_config(ref_get_config(arch, "reduced"), dtype="bfloat16")
        init = ssm.xlstm_init if cfg.family == "xlstm" else hybrid.init
        carried = pair(ref_get_config(arch, "reduced"), dtype="bfloat16")[5]
        for params in (init(cfg, 0, "cpu"), carried):
            for path, a in tree.flatten_with_path(params):
                fp32 = any(k in path for k in ("gate_bias", "a_log",
                                               "dt_bias", "d_skip"))
                assert a.dtype == (torch.float32 if fp32
                                   else torch.bfloat16), path


def test_xlstm_layout_matches_reference():
    """Pairs stacked per stage under ['stages'][s]['pairs'] with the
    reference's paths, shapes and dtypes, at FULL's two stages too."""
    for variant in ("reduced", "full"):
        ref_cfg = ref_get_config(ARCH, variant)
        if variant == "full":   # the full widths, two layers: a quick init
            ref_cfg = dataclasses.replace(ref_cfg, num_layers=4,
                                          vocab_size=512)
        cfg = port_config(ref_cfg)
        assert ssm.xlstm_stage_sizes(cfg) == ref_ssm.xlstm_stage_sizes(ref_cfg)
        shapes = jax.eval_shape(lambda: ref_ssm.xlstm_init(
            jax.random.PRNGKey(0), ref_cfg))
        params = ssm.xlstm_init(cfg, 0, "cpu")
        want = jax.tree_util.tree_flatten_with_path(shapes)[0]
        got = tree.flatten_with_path(params)
        assert [jax.tree_util.keystr(kp) for kp, _ in want] == [
            p for p, _ in got]
        for (kp, w), (path, a) in zip(want, got):
            assert tuple(a.shape) == w.shape, path
            assert str(a.dtype).split(".")[-1] == str(w.dtype), path


def test_loss_and_grads_match_reference():
    """Each leaf's atol is 1e-5 of its largest gradient: in the embedding
    gradient two of 65536 elements of the two fp32 runs differ by a few
    1e-6, about as far as each lies from a float64 evaluation there (the
    summation order, ROADMAP Queue 3)."""
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        ref_get_config(ARCH, "reduced"))
    ref_batch, batch = batches(cfg, seq=32)
    loss_and_grads_match(ref_model, model, params_np, params, ref_batch, batch,
                         atol_of_max=1e-5)


def test_remat_gives_the_same_grads():
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        ref_get_config(ARCH, "reduced"))
    _, batch = batches(cfg, seq=16)
    out = []
    for remat in (False, True):
        m = ssm._build_xlstm(dataclasses.replace(cfg, remat=remat))
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss, _ = m.loss_fn(tree.unflatten(params, leaves), batch)
        out.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch", [ARCH, "zamba2-7b"])
def test_bf16_forward_follows_reference_dtypes(arch):
    """bf16 weights: the blocks cast back to bf16 where the reference does
    (their outputs bf16), and the logits are fp32 and as close to the fp32
    logits as the reference's (``bf16_forward_matches``)."""
    _, _, params, batch, cfg = bf16_forward_matches(arch)
    with torch.no_grad():
        stack = params["stages"][0]["pairs" if arch == ARCH else "mamba"]
        unit = tree.tree_map(lambda a: a[0], stack)
        x = params["embed"]["tok"][batch["tokens"]]
        blocks = ([ssm.mlstm_apply(unit["mlstm"], x, cfg),
                   ssm.slstm_apply(unit["slstm"], x, cfg)] if arch == ARCH
                  else [ssm.mamba2_apply(unit, x, cfg)])
    assert x.dtype == torch.bfloat16
    assert all(b.dtype == torch.bfloat16 for b in blocks)


# ------------------------------------------------------------ stage adapter
@pytest.mark.parametrize("kw,S", [
    ({}, 2), (dict(num_layers=3), 2), (dict(num_stages=3), 2),
    (dict(num_layers=4, num_stages=4), 4), (dict(num_layers=8,
                                                  num_stages=4), 4)])
def test_xlstm_support_matches_reference(kw, S):
    ref_cfg = dataclasses.replace(FAMILY_CFGS["xlstm"], **kw)
    assert supported_reason(port_config(ref_cfg), S) == \
        ref_part.pipeline_supported(ref_cfg, S)


def test_xlstm_partition_merge_and_stagewise_forward():
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        FAMILY_CFGS["xlstm"])
    rp, part = (ref_part.make_partition(ref_model, 2),
                part_mod.make_partition(model, 2))
    assert isinstance(part, XLSTMAdapter)
    assert part.unit_counts() == rp.unit_counts() == {"pairs": [1, 1]}
    ref_stage, ref_shared = rp.partition_params(params_np)
    stage, shared = part.partition_params(params)
    for a, b in zip(tree.leaves(stage), jax.tree_util.tree_leaves(ref_stage),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sorted(shared) == sorted(ref_shared)
    back = part.merge_params(stage, shared)
    for (pa, a), (pb, b) in zip(tree.flatten_with_path(back),
                                tree.flatten_with_path(params)):
        assert pa == pb and torch.equal(a, b)
    ref_batch, batch = batches(cfg, seq=16)
    with torch.no_grad():
        x = part.embed(shared, batch)
        assert tuple(x.shape) == part.boundary_spec(batch).shape
        for s in range(2):
            local = part.split_units(tree.tree_map(lambda a: a[s], stage))
            x, aux = part.blocks_segment(local, shared, x, s, 0,
                                         part.num_units())
            assert float(aux) == 0.0
        loss = part.head_loss(shared, x, batch)
        flat, _ = model.loss_fn(params, batch)
    ref_loss, _ = ref_model.loss_fn(params_np, ref_batch)
    np.testing.assert_allclose(float(loss), float(flat), rtol=2e-5)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)


# ---------------------------------------------------------------- trainers
def test_flat_trainer_matches_reference():
    ref = ref_trainer(ref_get_config(ARCH, "reduced"))
    port = port_trainer(port_config(ref_get_config(ARCH, "reduced")))
    port.state = from_reference(jax.device_get(ref.state))
    want = ref.run(family_data(ref.model.config, reference=True))
    check_history(port.run(family_data(port.model.config)), want)


@pytest.mark.parametrize("cfg_name", ["reduced", "family"])
def test_pipe1_m2_matches_flat_trainer(cfg_name):
    """pipe = 1 at M = 2 (microbatches, the ring, the manual VJP, the
    per-stage sync) against the flat trainer, as the reference's
    ``test_pipelined_trainer_families_pipe1_parity``."""
    ref_cfg = (ref_get_config(ARCH, "reduced") if cfg_name == "reduced"
               else FAMILY_CFGS["xlstm"])
    cfg = port_config(ref_cfg, num_stages=1)
    flat = port_trainer(cfg).run(family_data(cfg))
    check_history(port_trainer(cfg, micro=2, pipe=1).run(family_data(cfg)),
                  flat)


@pytest.mark.parametrize("stash", ["replay", "full"])
def test_localpipe_s2_matches_flat_trainer(stash):
    """FAMILY_CFGS' xLSTM (two pairs) at S = 2 on LocalPipe, M = 2."""
    cfg = port_config(FAMILY_CFGS["xlstm"])
    flat = port_trainer(cfg).run(family_data(cfg))
    piped = port_trainer(cfg, micro=2, pipe=2, stash=stash).run(
        family_data(cfg))
    check_history(piped, flat)
