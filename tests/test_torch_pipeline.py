"""The port's stage partition, per-stage sync and pipelined entropy against
the reference's, on the same seeded numbers (numpy), at small sizes.

Bars: layouts, paths and plans equal exactly; the per-stage sync's ĝ and
EF at ``test_torch_compressor.py``'s fp32 bars (rtol 1e-5, atol 1e-6 per
unit of the largest magnitude), Q up to column sign at 1e-4; losses at
2e-5; pooled moments at rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressor as ref_comp
from repro.core import entropy as ref_entropy
from repro.core import wire as ref_wire
from repro.models.model import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro.pipeline import partition as ref_part
from repro.pipeline import sync as ref_psync

from repro_torch import tree
from repro_torch.core import bucketing, compressor, entropy, wire
from repro_torch.core.powersgd import LowRankState
from repro_torch.interop import from_reference
from repro_torch.interop import to_tensor
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.pipeline import partition as part_mod
from repro_torch.pipeline import sync as psync
from repro_torch.pipeline.adapters import supported_reason

RTOL, ATOL = 1e-5, 1e-6
MODEL = dict(name="pp", family="dense", num_layers=4, d_model=128,
             num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
             num_stages=2)
RAGGED = dict(MODEL, num_layers=3)          # stage sizes [2, 1]


def partition_reference_params(params_np, part):
    """A flat reference param tree (numpy) -> the port's (stage_stacked,
    shared) under the stage adapter ``part``."""
    return part.partition_params(tree.tree_map(to_tensor, params_np))


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol * scale)


def _close_up_to_sign(got, want, rtol=1e-4, atol=1e-4):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    dots = np.sum(got * want, axis=-2, keepdims=True)
    _close(got * np.where(dots < 0, -1.0, 1.0), want, rtol, atol)


def _both(cfg_kw):
    """The two packages' model and adapter; the reference's params as
    numpy, and the same params in the port."""
    ref_model = ref_build_model(RefModelConfig(**cfg_kw))
    params_np = jax.device_get(ref_model.init(jax.random.PRNGKey(0)))
    model = build_model(ModelConfig(**cfg_kw))
    params = tree.tree_map(to_tensor, params_np)
    S = cfg_kw["num_stages"]
    return (ref_model, ref_part.make_partition(ref_model, S), params_np,
            model, part_mod.make_partition(model, S), params)


def _np_tree(t):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(t)]


def _pt_tree(t):
    return [a.float().numpy() for a in tree.leaves(t)]


# ---------------------------------------------------------------- partition
@pytest.mark.parametrize("cfg_kw", [MODEL, RAGGED], ids=["uniform", "ragged"])
def test_partition_and_merge_equal_reference(cfg_kw):
    ref_model, rp, params_np, model, part, params = _both(cfg_kw)
    assert part.unit_counts() == rp.unit_counts()
    assert part.num_units() == rp.num_units()
    ref_stage, ref_shared = rp.partition_params(params_np)
    stage, shared = partition_reference_params(params_np, part)
    assert [p for p, _ in tree.flatten_with_path(stage)] == [
        jax.tree_util.keystr(k) for k, _ in
        jax.tree_util.tree_flatten_with_path(ref_stage)[0]]
    for a, b in zip(_pt_tree(stage), _np_tree(ref_stage)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_pt_tree(shared), _np_tree(ref_shared)):
        np.testing.assert_array_equal(a, b)
    local = psync.local_leaves_of(tree.tree_map(lambda a: a[1], stage))
    assert local == psync.stage_local_leaves(stage) == \
        ref_psync.local_leaves_of(jax.tree_util.tree_map(lambda a: a[1],
                                                         ref_stage))
    back = part.merge_params(stage, shared)
    assert [p for p, _ in tree.flatten_with_path(back)] == \
        [p for p, _ in tree.flatten_with_path(params)]
    for a, b in zip(tree.leaves(back), tree.leaves(params)):
        assert torch.equal(a, b)
    for s in range(2):
        want = rp.stage_flags("blocks", jnp.int32(s))
        got = part.stage_flags("blocks", s)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, np.asarray(want))
    # the uniform helpers of partition.py
    if cfg_kw is MODEL:
        st2, sh2 = part_mod.partition_params(params, 2)
        for a, b in zip(tree.leaves(st2), tree.leaves(stage)):
            assert torch.equal(a, b)
        merged = part_mod.merge_params(st2, sh2, 2)
        for a, b in zip(tree.leaves(merged), tree.leaves(params)):
            assert torch.equal(a, b)


def test_local_global_paths_and_support():
    for path in ("['stages'][3]['blocks']['attn']['wq']", "['embed']['tok']",
                 "['final_norm_scale']", "['stages'][12]['blocks']['x']"):
        assert part_mod.local_leaf_path(path) == \
            ref_part.local_leaf_path(path)
        loc = part_mod.local_leaf_path(path)
        if loc is not None:
            assert part_mod.global_leaf_path(*loc) == path
    assert part_mod.pipeline_supported(ModelConfig(**MODEL), 2) is None
    bad = ModelConfig(**dict(MODEL, num_stages=3))
    assert supported_reason(bad, 2) == ref_part.pipeline_supported(
        RefModelConfig(**dict(MODEL, num_stages=3)), 2)
    short = dict(MODEL, num_layers=1, num_stages=2)
    assert supported_reason(ModelConfig(**short), 2) == \
        ref_part.pipeline_supported(RefModelConfig(**short), 2)
    assert "must be >= 1" in supported_reason(ModelConfig(**MODEL), 0)
    # a family that neither package registers
    reason = supported_reason(ModelConfig(**dict(MODEL, family="nope")), 2)
    assert "no stage adapter" in reason
    assert reason == ref_part.pipeline_supported(
        RefModelConfig(**dict(MODEL, family="nope")), 2)
    with pytest.raises(ValueError, match="unsupported"):
        part_mod.make_partition(build_model(ModelConfig(**MODEL)), 3)


@pytest.mark.parametrize("cfg_kw", [MODEL, RAGGED], ids=["uniform", "ragged"])
def test_stagewise_forward_equals_flat_loss(cfg_kw):
    """embed -> each stage's blocks -> head reproduces the flat model's
    loss, in the port and against the reference's flat loss."""
    ref_model, _, params_np, model, part, params = _both(cfg_kw)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 16))
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    stage, shared = part.partition_params(params)
    with torch.no_grad():
        x = part.embed(shared, batch)
        aux = torch.zeros(())
        for s in range(2):
            local = part.split_units(tree.tree_map(lambda a: a[s], stage))
            for lo, hi in ((0, 1), (1, part.num_units())):
                x, a = part.blocks_segment(local, shared, x, s, lo, hi)
                aux = aux + a
        loss = part.head_loss(shared, x, batch) + aux
        flat, _ = model.loss_fn(params, batch)
    ref_loss, _ = ref_model.loss_fn(
        params_np, {k: jnp.asarray(toks, jnp.int32) for k in batch})
    np.testing.assert_allclose(float(loss), float(flat), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5,
                               atol=2e-5)


# ----------------------------------------------------------------- plans
def _plans(cfg_kw, stage_ranks, policy="edgc"):
    ref_model, rp, params_np, model, part, params = _both(cfg_kw)
    L = cfg_kw["num_layers"]
    ref_leaves = ref_comp.classify_leaves(params_np, L, 2, min_dim=64)
    leaves = compressor.classify_leaves(params, L, 2, min_dim=64)
    kw = (dict(stage_ranks=list(stage_ranks), num_stages=2)
          if policy == "edgc" else dict(fixed_rank=stage_ranks[0]))
    ref_plan = ref_comp.make_plan(policy, ref_leaves, **kw)
    plan = compressor.make_plan(policy, leaves, **kw)
    assert plan.ranks == ref_plan.ranks
    ref_stage, _ = rp.partition_params(params_np)
    stage, _ = part.partition_params(params)
    ref_sp = ref_psync.make_stage_plans(
        ref_plan, 2, ref_psync.stage_local_leaves(ref_stage),
        bucket_bytes=1 << 15)
    sp = psync.make_stage_plans(plan, 2, psync.stage_local_leaves(stage),
                                bucket_bytes=1 << 15)
    return ref_sp, sp, params_np, params, ref_plan, plan, rp, part


def _layout_fields(layout):
    return ([(g.m, g.n, g.rank, g.members) for g in layout.groups],
            [(b.members, b.itemsizes) for b in layout.buckets])


@pytest.mark.parametrize("cfg_kw,ranks,policy", [
    (MODEL, (4, 16), "edgc"), (MODEL, (8, 8), "edgc"), (MODEL, (8,), "fixed"),
    (RAGGED, (4, 8), "edgc")], ids=["distinct", "same", "fixed", "ragged"])
def test_make_stage_plans_equal_reference(cfg_kw, ranks, policy):
    ref_sp, sp, *_ = _plans(cfg_kw, ranks, policy)
    assert sp.num_stages == ref_sp.num_stages
    assert sp.stage_plans == tuple(
        type(sp.stage_plans[0])(ranks=p.ranks) for p in ref_sp.stage_plans)
    assert [(p.ranks, st) for p, st in sp.distinct] == \
        [(p.ranks, st) for p, st in ref_sp.distinct]
    assert sp.d_of_stage == ref_sp.d_of_stage
    for a, b in zip(sp.layouts, ref_sp.layouts, strict=True):
        assert _layout_fields(a) == _layout_fields(b)
    assert sp.predicted_collectives() == ref_sp.predicted_collectives()
    with pytest.raises(ValueError, match="non-stage leaf"):
        psync.make_stage_plans(
            type(sp.stage_plans[0])(ranks=(("['embed']['tok']", 4),)), 2, [])


def test_stage_wire_bytes_sums_to_plan():
    _, _, _, params, _, plan, _, _ = _plans(MODEL, (4, 16))
    leaves = compressor.classify_leaves(params, 4, 2, min_dim=64)
    per = psync.stage_wire_bytes(leaves, plan, 2)
    comp, full = compressor.plan_wire_bytes(leaves, plan)
    assert sum(c for c, _ in per) == comp and sum(f for _, f in per) == full
    assert per == ref_psync.stage_wire_bytes(
        ref_comp.classify_leaves(jax.device_get(
            ref_build_model(RefModelConfig(**MODEL)).init(
                jax.random.PRNGKey(0))), 4, 2, min_dim=64),
        ref_comp.make_plan("edgc", ref_comp.classify_leaves(
            jax.device_get(ref_build_model(RefModelConfig(**MODEL)).init(
                jax.random.PRNGKey(0))), 4, 2, min_dim=64),
            stage_ranks=[4, 16], num_stages=2), 2)


# ------------------------------------------------------------ per-stage sync
class _Replay:
    """Collective hooks for a coded sync in both packages (the rule of
    ``test_torch_wire.py``): ``record`` is the reference's identity psum
    and keeps each payload; ``replay`` is the port's and returns the
    reference's payload after holding its own to it, allowing only codes
    one quantizer step apart (fp32 products summed in another order land
    on the other side of a rounding boundary) in under 0.1% of the
    elements, so one flip cannot spread downstream."""

    def __init__(self, codec):
        self.codec, self.sent, self.calls = codec, [], 0

    def record(self, x):
        self.sent.append(np.asarray(x))
        return x

    def replay(self, x):
        want = self.sent[self.calls]
        self.calls += 1
        got = x.float().numpy()
        bar = RTOL * np.abs(want) + ATOL * max(1.0, float(np.abs(want).max()))
        off = np.abs(got - want.astype(np.float32)) > bar
        step = float(np.abs(want).max()) / self.codec.qmax
        assert np.abs(got - want)[off].max(initial=0.0) <= step * (1 + 1e-5)
        assert off.sum() <= 1e-3 * off.size, (off.sum(), off.size)
        return torch.from_numpy(np.array(want, np.float32)).to(x.dtype)


@pytest.mark.parametrize("cfg_kw,ranks,use_kernels,coded", [
    (MODEL, (4, 16), False, False), (MODEL, (4, 16), True, False),
    (MODEL, (8, 8), False, True), (RAGGED, (4, 8), False, False)],
    ids=["distinct", "kernels", "quant8", "ragged"])
def test_stage_sync_grads_equals_reference(cfg_kw, ranks, use_kernels, coded):
    """At each concrete stage: the port runs its stage's schedule only, the
    reference every schedule masked; the stage's ĝ, the shared leaves and
    the live (diagonal) compressor state agree."""
    ref_sp, sp, params_np, params, ref_plan, plan, rp, part = _plans(
        cfg_kw, ranks)
    ref_state = jax.device_get(ref_psync.init_pipeline_comp_state(
        params_np, ref_plan, jax.random.PRNGKey(1), ref_sp, wire_ef=coded))
    state = from_reference(
        {"stage_params": {}, "comp": ref_psync.replicate_pipeline_comp_state(
            ref_state, 1)})["comp"]
    rng = np.random.default_rng(0)
    grads_np = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params_np)
    ref_gs, ref_gsh = rp.partition_params(grads_np)
    gs, gsh = partition_reference_params(grads_np, part)
    ident = lambda x: x
    ref_codec = ref_wire.resolve_codec("quant8") if coded else None
    codec = wire.resolve_codec("quant8") if coded else None
    for s in range(2):
        hooks = _Replay(codec)
        ref_psum, psum = ((hooks.record, hooks.replay) if coded
                          else (ident, ident))
        ref_local = jax.tree_util.tree_map(lambda a: a[s], ref_gs)
        ref_c = jax.tree_util.tree_map(lambda a: a[s], ref_state)
        want_s, want_sh, want_c = ref_psync.stage_sync_grads(
            ref_local, ref_gsh, ref_c, ref_sp, ref_psum, my_stage=s,
            use_kernels=use_kernels, codec=ref_codec)
        local = tree.tree_map(lambda a: a[s], gs)
        comp_s = {k: (LowRankState(q=v.q[s], err=v.err[s])
                      if isinstance(v, LowRankState) else v[s])
                  for k, v in state.items()}
        got_s, got_sh, got_c = psync.stage_sync_grads(
            local, gsh, comp_s, sp, psum, my_stage=s,
            use_kernels=use_kernels, codec=codec)
        if coded:   # every payload of the one schedule and the shared bucket
            assert hooks.calls == len(hooks.sent)
        for a, b in zip(_pt_tree(got_s), _np_tree(want_s), strict=True):
            _close(a, b)
        for a, b in zip(_pt_tree(got_sh), _np_tree(want_sh), strict=True):
            _close(a, b)
        prefix = f"p{sp.d_of_stage[s]}:"
        assert set(got_c) == set(want_c)
        for key in got_c:
            if not key.startswith(prefix):
                # off-diagonal: the port leaves it as it was
                assert got_c[key] is comp_s[key]
                continue
            if isinstance(got_c[key], LowRankState):
                _close(got_c[key].err.numpy(), want_c[key].err)
                _close_up_to_sign(got_c[key].q.numpy(), want_c[key].q)
            else:
                _close(got_c[key].numpy(), want_c[key])
        # the executor syncs the shared leaves once, on its own
        _, none_sh, _ = psync.stage_sync_grads(local, None, comp_s, sp, ident,
                                               my_stage=s)
        assert none_sh is None


def test_init_pipeline_comp_state_layout_and_flat_warm_starts():
    """Keys and shapes as the reference's; with a uniform plan every stage
    slice holds the flat trainer's warm starts (same seeds)."""
    ref_sp, sp, params_np, params, ref_plan, plan, rp, part = _plans(
        MODEL, (8,), "fixed")
    ref_state = ref_psync.init_pipeline_comp_state(
        params_np, ref_plan, jax.random.PRNGKey(1), ref_sp, wire_ef=True)
    state = psync.init_pipeline_comp_state(params, plan, 77, sp, wire_ef=True)
    assert set(state) == set(ref_state)
    for k, v in state.items():
        got = [tuple(a.shape) for a in tree.leaves(v)]
        want = [tuple(a.shape) for a in jax.tree_util.tree_leaves(ref_state[k])]
        assert got == want, k
    flat = compressor.init_compressor_state(params, plan, 77)
    for s in range(2):
        live = bucketing.unstack_state(
            {k[len("p0:"):]: LowRankState(q=v.q[s], err=v.err[s])
             for k, v in state.items() if isinstance(v, LowRankState)},
            sp.layouts[0])
        for lp, st in live.items():
            want = flat[part_mod.global_leaf_path(s, lp)]
            assert torch.equal(st.q, want.q)
            assert not st.err.any()
    rep = psync.replicate_pipeline_comp_state(state, 3)
    for a, b in zip(tree.leaves(rep), tree.leaves(state)):
        assert a.shape == (b.shape[0], 3) + b.shape[1:]
        assert torch.equal(a[:, 2], b)


def test_resize_pipeline_comp_state_keeps_live_q_and_ef():
    """A re-plan from ranks (8, 8) to (4, 16): each stage's live slice keeps
    its EF and the leading columns of Q, as the reference's does from the
    same state."""
    ref_sp0, sp0, params_np, params, ref_plan0, plan0, rp, part = _plans(
        MODEL, (8, 8))
    ref_sp1, sp1, *_, ref_plan1, plan1, _, _ = _plans(MODEL, (4, 16))
    rng = np.random.default_rng(3)
    ref_st0 = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.standard_normal(a.shape), np.float32),
        jax.device_get(ref_psync.replicate_pipeline_comp_state(
            ref_psync.init_pipeline_comp_state(
                params_np, ref_plan0, jax.random.PRNGKey(2), ref_sp0,
                wire_ef=True), 1)))
    st0 = from_reference({"stage_params": {}, "comp": ref_st0})["comp"]
    ref_st1 = ref_psync.resize_pipeline_comp_state(
        ref_st0, ref_sp0, ref_sp1, jax.random.PRNGKey(3))
    st1 = psync.resize_pipeline_comp_state(st0, sp0, sp1, 5, "cpu")
    assert set(st1) == set(ref_st1)
    for s, r_new in ((0, 4), (1, 16)):
        d1 = sp1.d_of_stage[s]
        got = bucketing.unstack_state(
            {k[len(f"p{d1}:"):]: LowRankState(q=v.q[s], err=v.err[s])
             for k, v in st1.items()
             if k.startswith(f"p{d1}:") and isinstance(v, LowRankState)},
            sp1.layouts[d1])
        want = ref_comp_unstack(ref_st1, ref_sp1, d1, s)
        for lp, st in got.items():
            assert st.q.shape[-1] == r_new
            _close(st.err.numpy(), want[lp].err)
            keep = min(8, r_new)
            _close(st.q[..., :keep].numpy(), want[lp].q[..., :keep])
        for k, v in st1.items():
            if bucketing.EF_PREFIX in k and k.startswith(f"p{d1}:"):
                _close(v[s].numpy(), np.asarray(ref_st1[k])[s])


def test_resize_from_empty_state_puts_fresh_state_on_the_device():
    """The DAC's warm-up plan compresses nothing, so the state a first
    re-plan resizes is empty: the fresh warm starts go on the trainer's
    device, not on the CPU."""
    _, sp0, *_ = _plans(MODEL, (8,), "fixed")
    sp_none = psync.make_stage_plans(compressor.NO_COMPRESSION, 2, [
        (p, shp) for g in sp0.layouts[0].groups for p, shp in g.members])
    out = psync.resize_pipeline_comp_state({}, sp_none, sp0, 5,
                                           device=torch.device("meta"))
    assert out and all(a.device.type == "meta" for a in tree.leaves(out))


def ref_comp_unstack(state, splans, d, s):
    from repro.core import bucketing as ref_bucketing
    sub = {k[len(f"p{d}:"):]: jax.tree_util.tree_map(lambda a: a[s], v)
           for k, v in state.items()
           if k.startswith(f"p{d}:") and ref_bucketing.EF_PREFIX not in k}
    return ref_bucketing.unstack_state(sub, splans.layouts[d])


# ------------------------------------------------------ pipelined entropy
def test_sample_moments_lead_mask_equals_reference_on_ragged_plan():
    """3 layers over 2 stages pad stage 1's stack: the live-unit mask drops
    the pad samples, in both packages, and the pooled moments give the
    flat entropy."""
    from repro.core.entropy import GDSConfig as RefGDSConfig
    _, rp, params_np, _, part, _ = _both(RAGGED)
    rng = np.random.default_rng(0)
    grads_np = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params_np)
    ref_gs, ref_gsh = rp.partition_params(grads_np)
    gs, gsh = partition_reference_params(grads_np, part)
    gds = entropy.GDSConfig(alpha=0.5, beta=0.25)
    ref_gds = RefGDSConfig(alpha=0.5, beta=0.25)
    tot = np.zeros(3)
    padded = np.zeros(3)
    for s in range(2):
        mask = part.stage_flags("blocks", s)
        got = entropy.sample_moments(
            tree.tree_map(lambda a: a[s], gs["blocks"]), gds, lead_mask=mask)
        want = ref_entropy.sample_moments(
            jax.tree_util.tree_map(lambda a: a[s], ref_gs["blocks"]), ref_gds,
            lead_mask=rp.stage_flags("blocks", jnp.int32(s)))
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=RTOL)
        tot += [float(a) for a in got]
        padded += [float(a) for a in entropy.sample_moments(
            tree.tree_map(lambda a: a[s], gs["blocks"]), gds)]
    sh = entropy.sample_moments(gsh, gds)
    tot += [float(a) for a in sh]
    padded += [float(a) for a in sh]
    h = float(entropy.entropy_from_moments(*map(torch.tensor, tot)))
    flat = float(entropy.grads_entropy(tree.tree_map(to_tensor, grads_np), gds))
    assert abs(h - flat) < 1e-5
    h_pad = float(entropy.entropy_from_moments(*map(torch.tensor, padded)))
    assert h_pad < flat - 1e-3          # the bias the mask removes is real
