"""Zamba2 parity: the port's ``models/hybrid.py``, its ``ZambaAdapter``
(ragged per-stage plans) and its trainers against the reference's, on the
reduced config and ``tests/test_pipeline.py``'s ``FAMILY_CFGS`` (3 layers,
attn_every 2: groups [2, 1], one per stage at S = 2), with the reference's
weights carried across.

Bars: the fp32 loss at rtol 1e-5 and gradients at rtol 1e-4 (atol 1e-6,
raised to 1e-5 of a leaf's largest gradient as for xLSTM); stage plans
equal; trainer losses within 5e-3 (``tests/test_pipeline.py:553``'s) with
equal bytes; the pipelined pooled entropy within 1e-6 of the flat one
(``tests/test_pipeline.py:611``'s).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.entropy import grads_entropy as ref_grads_entropy
from repro.core import GDSConfig as RefGDSConfig
from repro.models import hybrid as ref_hybrid
from repro.pipeline import partition as ref_part

from _torch_families import (  # noqa: F401  (the autouse fixture)
    batches, check_history, family_data, loss_and_grads_match, pair,
    port_config, port_trainer, ref_trainer, small_torch_thread_pool)
from test_pipeline import FAMILY_CFGS

from repro_torch import tree
from repro_torch.core import GDSConfig
from repro_torch.core.entropy import (entropy_from_moments, grads_entropy,
                                      sample_moments)
from repro_torch.interop import from_reference
from repro_torch.models import hybrid
from repro_torch.pipeline import partition as part_mod
from repro_torch.pipeline.adapters import ZambaAdapter, supported_reason

ARCH = "zamba2-7b"


@pytest.mark.parametrize("attn_every", [1, 2, 3, 7])
@pytest.mark.parametrize("num_stages", [1, 2, 3, 4])
def test_stage_group_sizes_match_reference(attn_every, num_stages):
    """Whole groups per stage, near-even, over a grid of depths (81 and
    the 28 of the card's cut among them)."""
    for layers in list(range(1, 30)) + [81]:
        ref_cfg = dataclasses.replace(
            ref_get_config(ARCH, "reduced"), num_layers=layers,
            attn_every=attn_every, num_stages=num_stages)
        cfg = port_config(ref_cfg)
        assert hybrid._group_sizes(cfg) == ref_hybrid._group_sizes(ref_cfg)
        for S in (None, 1, 2, 4):
            assert hybrid.stage_group_sizes(cfg, S) == \
                ref_hybrid.stage_group_sizes(ref_cfg, S), (layers, S)
    full = port_config(ref_get_config(ARCH, "full"), num_layers=28)
    assert hybrid.stage_group_sizes(full) == [[7], [7], [7], [7]]


def test_layout_matches_reference():
    """Mamba2 layers stacked per stage under ['stages'][s]['mamba'] (ragged:
    2 and 1 layers), the shared block at top level, the fp32 leaves fp32."""
    for ref_cfg in (ref_get_config(ARCH, "reduced"), FAMILY_CFGS["zamba"]):
        ref_cfg = dataclasses.replace(ref_cfg, dtype="bfloat16")
        cfg = port_config(ref_cfg)
        shapes = jax.eval_shape(lambda: ref_hybrid.init(jax.random.PRNGKey(0),
                                                        ref_cfg))
        params = hybrid.init(cfg, 0, "cpu")
        want = jax.tree_util.tree_flatten_with_path(shapes)[0]
        got = tree.flatten_with_path(params)
        assert [jax.tree_util.keystr(kp) for kp, _ in want] == [
            p for p, _ in got]
        for (kp, w), (path, a) in zip(want, got):
            assert tuple(a.shape) == w.shape, path
            assert str(a.dtype).split(".")[-1] == str(w.dtype), path
    assert [tuple(st["mamba"]["in_proj"].shape)[0]
            for st in params["stages"]] == [2, 1]
    assert "attn" in params["shared"] and params["shared"]["attn"]["wq"].ndim == 2


@pytest.mark.parametrize("name", ["reduced", "family"])
def test_loss_and_grads_match_reference(name):
    ref_cfg = (ref_get_config(ARCH, "reduced") if name == "reduced"
               else FAMILY_CFGS["zamba"])
    ref_cfg, cfg, ref_model, model, params_np, params = pair(ref_cfg)
    ref_batch, batch = batches(cfg, seq=32)
    loss_and_grads_match(ref_model, model, params_np, params, ref_batch, batch,
                         atol_of_max=1e-5)


def test_shared_block_is_one_parameter_set_used_at_every_site():
    """The forward applies the one shared parameter set once per group
    (two groups here, two sites)."""
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        FAMILY_CFGS["zamba"])
    _, batch = batches(cfg, seq=16)
    sites = []
    orig = hybrid.shared_apply

    def spy(sp, x, cfg_, positions):
        sites.append(id(sp))
        return orig(sp, x, cfg_, positions)
    hybrid.shared_apply = spy
    try:
        with torch.no_grad():
            model.loss_fn(params, batch)
    finally:
        hybrid.shared_apply = orig
    assert len(sites) == len(hybrid._group_sizes(cfg)) == 2
    assert len(set(sites)) == 1


# ------------------------------------------------------------ stage adapter
@pytest.mark.parametrize("kw,S", [
    ({}, 2), (dict(num_stages=3), 2), (dict(num_layers=2), 2),
    (dict(num_layers=7, attn_every=2, num_stages=4), 4),
    (dict(num_layers=7, attn_every=3, num_stages=4), 4),
    (dict(num_layers=28, attn_every=7, num_stages=4), 4)])
def test_zamba_support_matches_reference(kw, S):
    ref_cfg = dataclasses.replace(FAMILY_CFGS["zamba"], **kw)
    assert supported_reason(port_config(ref_cfg), S) == \
        ref_part.pipeline_supported(ref_cfg, S)


def test_zamba_partition_is_padded_and_merges_back():
    """The ragged [2, 1] plan: stage 1's stack is zero-padded to 2 layers,
    as the reference's, and merging drops the pad."""
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        FAMILY_CFGS["zamba"])
    rp, part = (ref_part.make_partition(ref_model, 2),
                part_mod.make_partition(model, 2))
    assert isinstance(part, ZambaAdapter)
    assert part.unit_counts() == rp.unit_counts() == {"mamba": [2, 1]}
    assert part.num_units() == rp.num_units() == 1
    assert part.stage_flags("mamba", 1).tolist() == [True, False]
    ref_stage, ref_shared = rp.partition_params(params_np)
    stage, shared = part.partition_params(params)
    for a, b in zip(tree.leaves(stage), jax.tree_util.tree_leaves(ref_stage),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sorted(shared) == sorted(ref_shared) and "shared" in shared
    back = part.merge_params(stage, shared)
    for (pa, a), (pb, b) in zip(tree.flatten_with_path(back),
                                tree.flatten_with_path(params)):
        assert pa == pb and torch.equal(a, b)
    # stage s's layer i runs in group slot unit_index(s, i); pads in none
    assert [part.unit_index("mamba", 0, i) for i in range(2)] == [0, 0]
    assert [part.unit_index("mamba", 1, i) for i in range(2)] == [0, -1]


@pytest.mark.parametrize("layers,attn_every,S", [(3, 2, 2), (7, 2, 2),
                                                 (7, 3, 3)])
def test_zamba_stagewise_forward_equals_flat_loss(layers, attn_every, S):
    """embed -> each stage's group slots, one segment per slot -> head
    reproduces the flat loss of the port and of the reference, on ragged
    plans with stages of different group counts."""
    ref_cfg = dataclasses.replace(FAMILY_CFGS["zamba"], num_layers=layers,
                                  attn_every=attn_every, num_stages=S)
    ref_cfg, cfg, ref_model, model, params_np, params = pair(ref_cfg)
    part = part_mod.make_partition(model, S)
    ref_batch, batch = batches(cfg, seq=16)
    stage, shared = part.partition_params(params)
    with torch.no_grad():
        x = part.embed(shared, batch)
        for s in range(S):
            local = part.split_units(tree.tree_map(lambda a: a[s], stage))
            for g in range(part.num_units()):
                x, aux = part.blocks_segment(local, shared, x, s, g, g + 1)
                assert float(aux) == 0.0
        loss = part.head_loss(shared, x, batch)
        flat, _ = model.loss_fn(params, batch)
    ref_loss, _ = ref_model.loss_fn(params_np, ref_batch)
    np.testing.assert_allclose(float(loss), float(flat), rtol=2e-5)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)


def test_pipelined_entropy_matches_flat_ragged():
    """Pooling each stage's live units (the masks of the ragged plan) and
    the shared leaves once gives the flat entropy to 1e-6, which is the
    reference's flat entropy of the same gradients."""
    ref_cfg = FAMILY_CFGS["zamba"]
    cfg = port_config(ref_cfg)
    model = hybrid._build(cfg)
    params = model.init(0, "cpu")
    part = part_mod.make_partition(model, cfg.num_stages)
    rng = np.random.default_rng(0)
    grads_np = [rng.standard_normal(tuple(p.shape)).astype(np.float32)
                for p in tree.leaves(params)]
    grads = tree.unflatten(params, [torch.from_numpy(g) for g in grads_np])
    g_stage, g_shared = part.partition_params(grads)
    gds = GDSConfig(alpha=0.5, beta=0.25)
    z = torch.zeros(())
    n = s1 = s2 = z
    for s in range(cfg.num_stages):
        local = tree.tree_map(lambda a: a[s], g_stage)
        for key in sorted(local):
            kn, k1, k2 = sample_moments(local[key], gds,
                                        lead_mask=part.stage_flags(key, s))
            n, s1, s2 = n + kn, s1 + k1, s2 + k2
    n2, c1, c2 = sample_moments(g_shared, gds)
    pooled = float(entropy_from_moments(n + n2, s1 + c1, s2 + c2))
    flat = float(grads_entropy(grads, gds))
    assert abs(pooled - flat) < 1e-6, (pooled, flat)
    ref_params = jax.eval_shape(lambda: ref_hybrid.init(jax.random.PRNGKey(0),
                                                        ref_cfg))
    ref_grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(ref_params), grads_np)
    ref_flat = float(ref_grads_entropy(ref_grads,
                                       RefGDSConfig(alpha=0.5, beta=0.25)))
    assert abs(flat - ref_flat) < 1e-6, (flat, ref_flat)


# ---------------------------------------------------------------- trainers
def test_flat_trainer_matches_reference():
    ref = ref_trainer(ref_get_config(ARCH, "reduced"))
    port = port_trainer(port_config(ref_get_config(ARCH, "reduced")))
    port.state = from_reference(jax.device_get(ref.state))
    want = ref.run(family_data(ref.model.config, reference=True))
    check_history(port.run(family_data(port.model.config)), want)


@pytest.mark.parametrize("name", ["reduced", "family"])
def test_pipe1_m2_matches_flat_trainer(name):
    ref_cfg = (ref_get_config(ARCH, "reduced") if name == "reduced"
               else FAMILY_CFGS["zamba"])
    cfg = port_config(ref_cfg, num_stages=1)
    flat = port_trainer(cfg).run(family_data(cfg))
    check_history(port_trainer(cfg, micro=2, pipe=1).run(family_data(cfg)),
                  flat)


@pytest.mark.parametrize("layers", [3, 5])
@pytest.mark.parametrize("stash", ["replay", "full"])
def test_localpipe_s2_ragged_matches_flat_trainer(layers, stash):
    """pp-zamba's ragged plan at S = 2 on LocalPipe, M = 2: [2, 1] layers
    at 3 layers, and at 5 layers groups [[2, 2], [1]], whose full stash
    splits stage 0 between its two group slots. The padded layers are
    skipped and the shared block's gradient summed over the stages."""
    cfg = port_config(FAMILY_CFGS["zamba"], num_layers=layers)
    flat = port_trainer(cfg).run(family_data(cfg))
    piped = port_trainer(cfg, micro=2, pipe=2, stash=stash).run(
        family_data(cfg))
    check_history(piped, flat)
