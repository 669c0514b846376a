"""The port's partition rules against the reference's, entry for entry.

For every leaf of all 11 configs at their published widths (the reference's
trees from ``jax.eval_shape``, the port's on the ``meta`` device) the port's
``param_pspecs``, ``apply_fsdp``, ``stage_param_pspecs`` and
``cache_pspecs`` equal the reference's ``PartitionSpec``s on meshes with
model 1, 2, 4 and 16, data 2 and 16, and a pod axis. The reference's mesh
argument is a stand-in with ``axis_names`` and ``devices.shape``, so no
JAX device is needed; the port's is a dict of axis sizes.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.dist import sharding as ref_sharding
from repro.models.model import build_model as ref_build
from repro_torch import tree
from repro_torch.configs import ARCHS, get_config, sharding_mode
from repro_torch.dist import sharding
from repro_torch.models.model import build_model

MESHES = {
    "m1": {"data": 1, "model": 1},
    "m2": {"data": 1, "model": 2},
    "d2m4": {"data": 2, "model": 4},
    "d16m16": {"data": 16, "model": 16},
    "pod2": {"pod": 2, "data": 2, "model": 2},
    "d2": {"data": 2},
}


def _ref_mesh(sizes: dict):
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


@functools.lru_cache(maxsize=None)
def _trees(arch: str):
    ref_model = ref_build(ref_configs.get_config(arch, "full"))
    ref = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    with torch.device("meta"):
        port = build_model(get_config(arch, "full")).init(0, "meta")
    return ref, port


def _ref_specs(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(kp): tuple(s) for kp, s in flat}


def _port_specs(like, specs) -> dict:
    paths = [p for p, _ in tree.flatten_with_path(like)]
    return dict(zip(paths, sharding.spec_leaves(specs)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_fsdp_specs_equal_reference(arch, mesh):
    ref, port = _trees(arch)
    sizes = MESHES[mesh]
    rmesh = _ref_mesh(sizes)
    want = _ref_specs(ref_sharding.param_pspecs(ref, rmesh))
    got = _port_specs(port, sharding.param_pspecs(port, sizes))
    assert got == want
    axes = ref_sharding._dp_prefix(rmesh)
    want = _ref_specs(ref_sharding.apply_fsdp(
        ref_sharding.param_pspecs(ref, rmesh), ref, rmesh, axes))
    got = _port_specs(port, sharding.apply_fsdp(
        sharding.param_pspecs(port, sizes), port, sizes, axes))
    assert got == want
    assert got == _port_specs(port, sharding.param_specs(port, sizes,
                                                         fsdp=True))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_stage_specs_equal_reference(arch):
    """Stage-stacked trees of the family's own adapter, on a mesh with and
    without a pipe axis."""
    import dataclasses
    from repro.pipeline.adapters import make_adapter as ref_adapter
    from repro_torch.pipeline.adapters import make_adapter
    rcfg = ref_configs.get_config(arch, "full")
    S = rcfg.num_stages if rcfg.num_stages > 1 else 2
    ref_model = ref_build(dataclasses.replace(rcfg, num_stages=S))
    ref_stage = jax.eval_shape(
        lambda p: ref_adapter(ref_model, S).partition_params(p)[0],
        jax.eval_shape(ref_model.init, jax.random.PRNGKey(0)))
    with torch.device("meta"):
        model = build_model(dataclasses.replace(get_config(arch, "full"),
                                                num_stages=S))
        stage = make_adapter(model, S).partition_params(
            model.init(0, "meta"))[0]
    for sizes in ({"pipe": 2, "data": 2, "model": 4}, {"data": 2, "model": 2},
                  {"pipe": 2, "data": 1, "model": 16}):
        rmesh = _ref_mesh(sizes)
        want = _ref_specs(ref_sharding.stage_param_pspecs(ref_stage, rmesh))
        got = _port_specs(stage, sharding.stage_param_pspecs(stage, sizes))
        assert got == want, sizes


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_reference(arch):
    """Each family's decode cache: K/V leaves over the data axes and the
    kv heads, SSM states and conv tails batch-major, the length replicated."""
    bs, max_len = 16, 64
    ref_model = ref_build(ref_configs.get_config(arch, "full"))
    ref_cache = jax.eval_shape(lambda: ref_model.init_cache(bs, max_len))
    cache = build_model(get_config(arch, "full")).init_cache(
        bs, max_len, device="meta")
    for sizes in (MESHES["d2m4"], MESHES["pod2"], MESHES["d16m16"],
                  {"data": 3, "model": 2}, MESHES["d2"]):
        rmesh = _ref_mesh(sizes)
        want = _ref_specs(ref_sharding.cache_pspecs(ref_cache, rmesh, bs))
        got = _port_specs(cache, sharding.cache_pspecs(cache, sizes, bs))
        assert got == want, sizes


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_pspec_equals_reference(mesh):
    sizes = MESHES[mesh]
    rmesh = _ref_mesh(sizes)
    for ndim in range(4):
        for batch in (1, 2, 6, 8, 32, 64):
            want = tuple(ref_sharding.batch_pspec(ndim, rmesh, batch))
            assert sharding.batch_pspec(ndim, sizes, batch) == want


def test_sharding_modes_equal_reference():
    for arch in ARCHS:
        assert sharding_mode(arch) == ref_configs.sharding_mode(arch)
    assert {a for a in ARCHS if sharding_mode(a) == "auto"} == {
        "llama3-405b", "kimi-k2-1t-a32b", "qwen3-moe-235b-a22b"}


def test_divisibility_guard_and_rule_classes():
    """A dim the model size does not divide stays unsharded; each rule
    class shards its own dim."""
    cases = {
        "['stages'][0]['blocks']['attn']['wq']": ((2, 64, 96), (None, None, "model")),
        "['stages'][0]['blocks']['attn']['wo']": ((2, 96, 64), (None, "model", None)),
        "['stages'][0]['blocks']['moe']['experts']['up']": (
            (2, 6, 64, 32), (None, "model", None, None)),
        "['embed']['tok']": ((96, 64), ("model", None)),
        "['stages'][0]['blocks']['moe']['router']": ((2, 64, 6), ()),
        "['pos_embed']": ((64, 64), ()),
        "['final_norm_scale']": ((64,), ()),
    }
    for path, (shape, spec) in cases.items():
        assert sharding._spec_for(path, shape, {"model": 3}) == spec, path
        assert sharding._spec_for(path, shape, {"model": 1}) == spec, path
        # 5 divides none of these dims: every leaf stays whole
        assert all(e is None for e in
                   sharding._spec_for(path, shape, {"model": 5})), path
    assert sharding._spec_for("['embed']['tok']", (50257, 1920),
                              {"model": 2}) == (None, None)
    assert sharding._spec_for("['lm_head']", (64, 64), {"data": 4}) == ()


def test_to_placements_and_local_chunk():
    mesh = types.SimpleNamespace(
        mesh_dim_names=("data", "model"), shape=(2, 4),
        size=lambda i: (2, 4)[i], get_local_rank=lambda i: (1, 2)[i])
    assert sharding.to_placements(("data", None, "model"), mesh) == (
        Shard(0), Shard(2))
    assert sharding.to_placements((), mesh) == (Replicate(), Replicate())
    assert sharding.to_placements((("data", "model"), None), mesh) == (
        Shard(0), Shard(0))
    with pytest.raises(ValueError, match="pipe"):
        sharding.to_placements(("pipe",), mesh)
    t = torch.arange(16 * 8).reshape(16, 8)
    got = sharding.local_chunk(t, (Shard(0), Shard(1)), mesh)
    assert torch.equal(got, t[8:16, 4:6])
    # a dim split over both axes: data-major, then model
    got = sharding.local_chunk(t, (Shard(0), Shard(0)), mesh)
    assert torch.equal(got, t[8 + 2 * 2: 8 + 3 * 2])
