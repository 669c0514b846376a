"""MoE parity: the port's ``models/moe.py``, its stage adapter and its
trainers against the reference's, on the reduced configs of
qwen3-moe-235b-a22b and kimi-k2-1t-a32b in fp32, with the reference's
weights carried across by ``from_reference`` and inputs made from a seed
with numpy.

Bars: dispatch masks and top-k choices exactly; combine weights and the
aux loss at 1e-6; the loss at rtol 1e-5 and every gradient at rtol 1e-4,
atol 1e-6 (``test_torch_model.py``'s); the bucketed sync's ĝ and EF at
slice 1's fp32 bar (rtol 1e-5, atol 1e-6 per unit of the largest
magnitude), Q up to column sign at 1e-4; trainer losses within 5e-3
(``test_torch_trainer.py``'s bar), pipelined at M = 2 within the
reference's own 0.2 envelope (``tests/test_pipeline.py``), with
``bytes_synced`` equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as ref_get_config
from repro.core import EDGCConfig as RefEDGCConfig
from repro.core import GDSConfig as RefGDSConfig
from repro.core import bucketing as ref_bucketing
from repro.core import compressor as ref_comp
from repro.core import powersgd as ref_psgd
from repro.core.dac import DACConfig as RefDACConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import moe as ref_moe
from repro.models.model import active_param_count as ref_active_param_count
from repro.models.model import build_model as ref_build_model
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.pipeline import partition as ref_part
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import EDGCConfig, GDSConfig, bucketing, compressor
from repro_torch.core import powersgd
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import from_reference, to_tensor
from repro_torch.models import moe
from repro_torch.models.model import active_param_count, build_model
from repro_torch.optim import adam
from repro_torch.optim.adam import AdamConfig
from repro_torch.pipeline import partition as part_mod
from repro_torch.pipeline.adapters import MoEAdapter, supported_reason
from repro_torch.train.step import TrainStepConfig, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"]
RTOL, ATOL = 1e-5, 1e-6
STEPS = 3
DATA = dict(seq_len=32, batch_size=4, seed=3)


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


def _pair(arch):
    """Both packages' reduced config and model; the reference's fp32
    weights as numpy and in the port."""
    ref_cfg, cfg = ref_get_config(arch, "reduced"), get_config(arch, "reduced")
    port_fields, ref_fields = dataclasses.asdict(cfg), dataclasses.asdict(ref_cfg)
    for name in port_fields.keys() & ref_fields.keys():
        assert port_fields[name] == ref_fields[name], name
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    params_np = jax.device_get(ref_model.init(jax.random.PRNGKey(3)))
    params = from_reference({"params": params_np})["params"]
    return ref_cfg, cfg, ref_model, model, params_np, params


def _ffn(params_np, layer=0):
    """Block ``layer``'s MoE FFN of stage 0, as numpy."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[layer],
                                  params_np["stages"][0]["blocks"]["moe"])


def _tokens(n, d, seed, zero_rows=0):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    x[:zero_rows] = 0.0       # uniform router probabilities: every expert ties
    return x


def _batch(cfg, seed=5, seq=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, seq + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ------------------------------------------------------------------- routing
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n,group,capacity", [
    (48, 16, None),      # three whole groups, the capacity-factor rule
    (50, 16, None),      # ragged: two tokens past the last group
    (64, 32, 1),         # a tiny capacity: most assignments dropped
    (40, 1024, None),    # one group of all N tokens (S = min(group, N))
])
def test_route_matches_reference(arch, n, group, capacity):
    ref_cfg, cfg, _, _, params_np, _ = _pair(arch)
    ffn_np = _ffn(params_np)
    x = _tokens(n, cfg.d_model, seed=n + group, zero_rows=3)
    ref_out = ref_moe.route(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, ffn_np), ref_cfg, group, capacity)
    got = moe.route(torch.from_numpy(x), tree.tree_map(to_tensor, ffn_np),
                    cfg, group, capacity)
    ref_xg, ref_dispatch, ref_combine, ref_aux = (np.asarray(a) for a in ref_out)
    xg, dispatch, combine, aux = got
    assert dispatch.dtype == torch.bool and combine.dtype == torch.float32
    assert tuple(dispatch.shape) == ref_dispatch.shape
    np.testing.assert_array_equal(xg.numpy(), ref_xg)
    np.testing.assert_array_equal(dispatch.numpy(), ref_dispatch)
    np.testing.assert_allclose(combine.numpy(), ref_combine, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-6, atol=1e-6)
    routed = xg.shape[0] * xg.shape[1] * cfg.experts_per_token
    if capacity == 1:
        assert int(dispatch.sum()) < routed      # the capacity dropped some
    else:
        # the tied rows (zero tokens) go to the lowest experts, as top_k
        # does: each of the three holds a slot at experts 0 .. k-1 only
        held = dispatch[0, :3].any(dim=-1)       # (3, E)
        k = cfg.experts_per_token
        assert held[:, :k].all() and not held[:, k:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_rule_matches_reference(arch):
    """C = max(k, int(S k / E cf)) in Python floats, for many group sizes."""
    ref_cfg, cfg = ref_get_config(arch, "reduced"), get_config(arch, "reduced")
    router = jax.ShapeDtypeStruct((cfg.d_model, cfg.num_experts), jnp.float32)
    for s in (1, 2, 7, 16, 100, 1000, 1024, 4096):
        x = jax.ShapeDtypeStruct((s, cfg.d_model), jnp.float32)
        want = jax.eval_shape(lambda x, r, s=s: ref_moe.route(
            x, {"router": r}, ref_cfg, s), x, router)[1].shape[-1]
        assert moe.capacity_of(cfg, s) == want, s


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,group", [((2, 21), 16), ((2, 24), 1024)],
                         ids=["ragged", "whole"])
def test_moe_ffn_apply_matches_reference(arch, shape, group):
    ref_cfg, cfg, _, _, params_np, _ = _pair(arch)
    ffn_np = _ffn(params_np, layer=-1)
    x = _tokens(shape[0] * shape[1], cfg.d_model, seed=7).reshape(
        shape + (cfg.d_model,))
    ref_y, ref_aux = ref_moe.moe_ffn_apply(
        jax.tree_util.tree_map(jnp.asarray, ffn_np), jnp.asarray(x), ref_cfg,
        group_size=group)
    y, aux = moe.moe_ffn_apply(tree.tree_map(to_tensor, ffn_np),
                               torch.from_numpy(x), cfg, group_size=group)
    _close(y.numpy(), ref_y)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-6, atol=1e-6)


def test_ragged_tail_gets_zeros():
    """B*T not a multiple of S: the tokens past the last group get zeros."""
    cfg = get_config("qwen3-moe-235b-a22b", "reduced")
    ffn = tree.tree_map(lambda a: a[0],
                        build_model(cfg).init(0, "cpu")["stages"][0]["blocks"]["moe"])
    x = torch.from_numpy(_tokens(2 * 21, cfg.d_model, seed=1).reshape(2, 21, -1))
    y, _ = moe.moe_ffn_apply(ffn, x, cfg, group_size=16)   # 42 = 2 x 16 + 10
    flat = y.reshape(42, -1)
    assert torch.count_nonzero(flat[32:]) == 0 and torch.all(
        flat[:32].abs().sum(-1) > 0)


# --------------------------------------------------------------- the model
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    ref_cfg, cfg, ref_model, model, params_np, params = _pair(arch)
    batch_np = _batch(cfg)
    ref_batch = {k: jnp.asarray(v, jnp.int32) for k, v in batch_np.items()}
    (ref_loss, ref_mets), ref_grads = jax.value_and_grad(
        ref_model.loss_fn, has_aux=True)(params_np, ref_batch)
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    batch = {k: torch.from_numpy(v).long() for k, v in batch_np.items()}
    loss, mets = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert set(mets) == set(ref_mets) == {"loss", "aux"}
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    for k in mets:
        np.testing.assert_allclose(float(mets[k].detach()), float(ref_mets[k]),
                                   rtol=1e-5)
    router = params["stages"][0]["blocks"]["moe"]["router"]
    assert router.dtype == torch.float32
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(ref_flat) == len(grads)
    for (kp, want), got, (path, _) in zip(ref_flat, grads,
                                          tree.flatten_with_path(params)):
        assert jax.tree_util.keystr(kp) == path
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_init_layout(arch):
    """The port's own init has the reference's tree, shapes and dtypes (the
    router fp32 under bf16), and per-block remat changes no gradient."""
    ref_cfg, cfg = ref_get_config(arch, "reduced"), get_config(arch, "reduced")
    for dtype in ("float32", "bfloat16"):
        shapes = jax.eval_shape(
            ref_build_model(dataclasses.replace(ref_cfg, dtype=dtype)).init,
            jax.random.PRNGKey(0))
        params = build_model(dataclasses.replace(cfg, dtype=dtype)).init(0, "cpu")
        ref_flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        got = tree.flatten_with_path(params)
        assert [p for p, _ in got] == [jax.tree_util.keystr(k) for k, _ in ref_flat]
        for (path, a), (_, s) in zip(got, ref_flat):
            assert tuple(a.shape) == s.shape, path
            assert str(a.dtype)[6:] == str(s.dtype), path
    params = build_model(cfg).init(0, "cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(cfg).items()}
    out = []
    for remat in (False, True):
        m = build_model(dataclasses.replace(cfg, remat=remat))
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss, _ = m.loss_fn(tree.unflatten(params, leaves), batch)
        out.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_matches_reference(arch):
    ref_cfg, cfg, _, _, params_np, params = _pair(arch)
    assert active_param_count(cfg, params) == ref_active_param_count(
        ref_cfg, params_np)
    assert active_param_count(cfg, params) < sum(a.numel() for a in
                                                tree.leaves(params))


# ----------------------------------------------------------------- the sync
def _sync_setup(arch, rank=8):
    ref_cfg, cfg, _, model, params_np, params = _pair(arch)
    ref_leaves = ref_comp.classify_leaves(params_np, ref_cfg.num_layers,
                                          ref_cfg.num_stages, min_dim=64)
    leaves = compressor.classify_leaves(params, cfg.num_layers,
                                        cfg.num_stages, min_dim=64)
    ref_plan = ref_comp.make_plan("fixed", ref_leaves, fixed_rank=rank)
    plan = compressor.make_plan("fixed", leaves, fixed_rank=rank)
    return ref_leaves, leaves, ref_plan, plan, params_np, params


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_and_layout_match_reference(arch):
    ref_leaves, leaves, ref_plan, plan, _, _ = _sync_setup(arch)
    assert leaves == [type(leaves[0])(*dataclasses.astuple(l))
                      for l in ref_leaves]
    assert plan.ranks == ref_plan.ranks
    compressed = {p for p, _ in plan.ranks}
    assert any("experts" in p for p in compressed)
    assert not any("router" in p or "embed" in p or "lm_head" in p
                   for p in compressed)
    layout = bucketing.make_bucket_layout(leaves, plan)
    ref_layout = ref_bucketing.make_bucket_layout(ref_leaves, ref_plan)
    assert [(g.m, g.n, g.rank, tuple((p, tuple(s)) for p, s in g.members))
            for g in layout.groups] == [
        (g.m, g.n, g.rank, tuple((p, tuple(s)) for p, s in g.members))
        for g in ref_layout.groups]
    assert [tuple((p, tuple(s)) for p, s in b.members) for b in layout.buckets] \
        == [tuple((p, tuple(s)) for p, s in b.members)
            for b in ref_layout.buckets]
    assert layout.num_collectives() == ref_layout.num_collectives()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_bucketed_sync_matches_reference(arch, use_kernels):
    """One MoE gradient tree (4-D expert leaves stacked per shape group)
    through both packages' bucketed sync, twice (the second round reads
    the first's EF and Q)."""
    ref_leaves, leaves, ref_plan, plan, params_np, params = _sync_setup(arch)
    layout = bucketing.make_bucket_layout(leaves, plan)
    ref_layout = ref_bucketing.make_bucket_layout(ref_leaves, ref_plan)
    flat = tree.flatten_with_path(params)
    rng = np.random.default_rng(11)
    q_np = {g.key: rng.standard_normal(
        (g.stack_size, g.n, g.rank)).astype(np.float32) for g in layout.groups}
    state = {k: powersgd.LowRankState(q=torch.from_numpy(q),
                                      err=torch.zeros(g.stack_size, g.m, g.n))
             for (k, q), g in zip(q_np.items(), layout.groups)}
    ref_state = {k: ref_psgd.LowRankState(q=jnp.asarray(q),
                                          err=jnp.zeros((g.stack_size, g.m, g.n)))
                 for (k, q), g in zip(q_np.items(), layout.groups)}
    treedef = jax.tree_util.tree_structure(params_np)
    for round_ in range(2):
        g_np = [rng.standard_normal(tuple(a.shape)).astype(np.float32)
                for _, a in flat]
        synced, state = bucketing.bucketed_sync_grads(
            tree.unflatten(params, [torch.from_numpy(g) for g in g_np]),
            state, layout, lambda x: x, use_kernels=use_kernels)
        ref_synced, ref_state = ref_bucketing.bucketed_sync_grads(
            jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g) for g in g_np]),
            ref_state, ref_layout, lambda x: x, use_kernels=use_kernels)
        for (path, got), want in zip(tree.flatten_with_path(synced),
                                     jax.tree_util.tree_leaves(ref_synced)):
            _close(got.numpy(), want)
        assert set(state) == set(ref_state)
        for key, st in state.items():
            _close(st.err.numpy(), ref_state[key].err)
            _close_up_to_sign(st.q.numpy(), ref_state[key].q)


def test_from_reference_carries_moe_state():
    """A reference trainer's MoE state comes across unchanged: the 4-D
    expert leaves, the fp32 router, the group-stacked compressor state."""
    ref = _ref_trainer("kimi-k2-1t-a32b")
    state_np = jax.device_get(ref.state)
    state = from_reference(state_np)
    for key in ("params", "opt_m", "opt_v"):
        ref_flat = jax.tree_util.tree_flatten_with_path(state_np[key])[0]
        got = tree.flatten_with_path(state[key])
        assert [p for p, _ in got] == [jax.tree_util.keystr(k) for k, _ in ref_flat]
        for (_, a), (_, b) in zip(got, ref_flat):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    experts = state["params"]["stages"][0]["blocks"]["moe"]["experts"]
    assert experts["gate"].ndim == 4
    assert set(state["comp"]) == set(state_np["comp"])
    for key, st in state["comp"].items():
        np.testing.assert_array_equal(st.q.numpy(),
                                      np.asarray(state_np["comp"][key].q)[0])
        np.testing.assert_array_equal(st.err.numpy(),
                                      np.asarray(state_np["comp"][key].err)[0])


# ---------------------------------------------------------------- trainers
def _ref_mesh(pipe=False):
    if pipe:
        devs = np.array(jax.devices()[:1]).reshape(1, 1, 1)
        return Mesh(devs, ("pipe", "data", "model"),
                    axis_types=(AxisType.Auto,) * 3)
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    return Mesh(devs, ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _tkw(cfg, micro):
    return dict(total_steps=STEPS, log_every=1, num_microbatches=micro,
                schedule="1f1b", stash_policy="replay")


def _ref_trainer(arch, num_stages=None, micro=0, pipe=False):
    cfg = ref_get_config(arch, "reduced")
    if num_stages is not None:
        cfg = dataclasses.replace(cfg, num_stages=num_stages)
    edgc = RefEDGCConfig(policy="fixed", fixed_rank=8,
                         num_stages=cfg.num_stages, total_iterations=STEPS,
                         gds=RefGDSConfig(alpha=0.5, beta=0.25),
                         dac=RefDACConfig(window=2, adjust_limit=4))
    tcfg = RefTrainerConfig(adam=RefAdamConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=STEPS),
                            **_tkw(cfg, micro))
    return RefTrainer(ref_build_model(cfg), _ref_mesh(pipe), edgc, tcfg,
                      seed=0)


def _port_trainer(arch, num_stages=None, micro=0, pipe=None):
    cfg = get_config(arch, "reduced")
    if num_stages is not None:
        cfg = dataclasses.replace(cfg, num_stages=num_stages)
    edgc = EDGCConfig(policy="fixed", fixed_rank=8, num_stages=cfg.num_stages,
                      total_iterations=STEPS,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=2, adjust_limit=4))
    tcfg = TrainerConfig(adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=STEPS),
                         **_tkw(cfg, micro))
    return Trainer(build_model(cfg), edgc, tcfg, seed=0, device="cpu",
                   pipe=pipe)


def _data(arch):
    vocab = get_config(arch, "reduced").vocab_size
    return (RefSyntheticLM(vocab, **DATA).batches(),
            SyntheticLM(vocab, **DATA).batches())


def _check(got, want, bar):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for a, b in zip(got, want, strict=True):
        assert np.isfinite(a["loss"])
        assert abs(a["loss"] - b["loss"]) < bar, (a, b)
        assert a["bytes_synced"] == b["bytes_synced"]
        assert a["bytes_full"] == b["bytes_full"]


def test_flat_trainer_matches_reference():
    """Three flat steps of qwen3-moe reduced from the reference's state."""
    arch = "qwen3-moe-235b-a22b"
    ref, port = _ref_trainer(arch), _port_trainer(arch)
    assert port.leaves == [type(port.leaves[0])(*dataclasses.astuple(l))
                           for l in ref.leaves]
    port.state = from_reference(jax.device_get(ref.state))
    ref_data, data = _data(arch)
    want = ref.run(ref_data)
    got = port.run(data)
    _check(got, want, 5e-3)
    assert port.bytes_synced == ref.bytes_synced
    assert all("aux" in h and np.isfinite(h["aux"]) for h in got)
    ref_params = jax.tree_util.tree_leaves(jax.device_get(ref.state["params"]))
    for a, b in zip(tree.leaves(port.state["params"]), ref_params):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("micro,bar", [(1, 5e-3), (2, 0.2)])
def test_pipelined_trainer_pipe1_matches_reference(micro, bar):
    """pipe = 1 on both packages from the reference's state: at M = 1
    within the flat bar of the reference's pipelined trainer; at M = 2
    (per-microbatch router statistics) within the reference's envelope of
    its flat trainer, and within the flat bar of its M = 2 run."""
    arch = "qwen3-moe-235b-a22b"
    ref_p = _ref_trainer(arch, num_stages=1, micro=micro, pipe=True)
    port = _port_trainer(arch, num_stages=1, micro=micro, pipe=1)
    port.state = from_reference(jax.device_get(ref_p.state))
    ref_data, data = _data(arch)
    want = ref_p.run(ref_data)
    got = port.run(data)
    _check(got, want, 5e-3)
    if micro == 2:
        ref_flat = _ref_trainer(arch)
        flat = ref_flat.run(_data(arch)[0])
        _check(got, flat, bar)


# ------------------------------------------------------------ stage adapter
def _adapter_pair(arch, S=2):
    ref_cfg, cfg, ref_model, model, params_np, params = _pair(arch)
    ref_cfg = dataclasses.replace(ref_cfg, num_stages=S)
    cfg = dataclasses.replace(cfg, num_stages=S)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    params_np = jax.device_get(ref_model.init(jax.random.PRNGKey(3)))
    params = from_reference({"params": params_np})["params"]
    return (ref_model, ref_part.make_partition(ref_model, S), params_np,
            model, part_mod.make_partition(model, S), params)


def test_moe_support_matches_reference():
    for arch in ARCHS:
        ref_cfg, cfg = ref_get_config(arch, "reduced"), get_config(arch, "reduced")
        for S in (1, 2, 3):
            for stages in (1, 2, 3):
                rc = dataclasses.replace(ref_cfg, num_stages=stages)
                c = dataclasses.replace(cfg, num_stages=stages)
                assert supported_reason(c, S) == ref_part.pipeline_supported(rc, S)
    assert supported_reason(get_config("kimi-k2-1t-a32b", "reduced"), 2) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_partition_and_merge_round_trip(arch):
    ref_model, rp, params_np, model, part, params = _adapter_pair(arch)
    assert isinstance(part, MoEAdapter)
    assert part.unit_counts() == rp.unit_counts()
    assert part.num_units() == rp.num_units()
    ref_stage, ref_shared = rp.partition_params(params_np)
    stage, shared = part.partition_params(params)
    assert [p for p, _ in tree.flatten_with_path(stage)] == [
        jax.tree_util.keystr(k) for k, _ in
        jax.tree_util.tree_flatten_with_path(ref_stage)[0]]
    for a, b in zip(tree.leaves(stage), jax.tree_util.tree_leaves(ref_stage)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sorted(shared) == sorted(ref_shared) == [
        "embed", "final_norm_scale", "lm_head"]
    back = part.merge_params(stage, shared)
    for (pa, a), (pb, b) in zip(tree.flatten_with_path(back),
                                tree.flatten_with_path(params)):
        assert pa == pb and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_stagewise_forward_equals_flat_loss(arch):
    """embed -> each stage's segments (aux summed) -> head equals the flat
    loss, in the port and against the reference's."""
    ref_model, rp, params_np, model, part, params = _adapter_pair(arch)
    batch_np = _batch(get_config(arch, "reduced"), seq=16)
    batch = {k: torch.from_numpy(v).long() for k, v in batch_np.items()}
    stage, shared = part.partition_params(params)
    with torch.no_grad():
        x = part.embed(shared, batch)
        aux = torch.zeros(())
        for s in range(2):
            local = part.split_units(tree.tree_map(lambda a: a[s], stage))
            x, a = part.blocks_segment(local, shared, x, s, 0,
                                       part.num_units())
            assert a.item() > 0
            aux = aux + a
        loss = part.head_loss(shared, x, batch) + aux
        flat, _ = model.loss_fn(params, batch)
    ref_loss, _ = ref_model.loss_fn(
        params_np, {k: jnp.asarray(v, jnp.int32) for k, v in batch_np.items()})
    np.testing.assert_allclose(float(loss), float(flat), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5,
                               atol=2e-5)


def test_localpipe_s2_step_matches_flat_step():
    """kimi-k2 reduced (two stages) on ``LocalPipe`` at M = 1 against the
    port's flat trainer on the same weights and batches."""
    arch = "kimi-k2-1t-a32b"
    flat = _port_trainer(arch)
    piped = _port_trainer(arch, micro=1, pipe=2)
    stage, _ = piped._part.partition_params(flat.state["params"])
    for a, b in zip(tree.leaves(stage), tree.leaves(piped.state["stage_params"])):
        assert torch.equal(a, b)        # one seed, the same weights
    want = flat.run(_data(arch)[1])
    got = piped.run(_data(arch)[1])
    _check(got, want, 5e-3)


# ------------------------------------------------------- the donated step
def test_donated_step_equals_functional_step(monkeypatch):
    """The flat step with ``donate`` gives the functional step's state bit
    for bit, in the given tensors (the EF residuals and the AdamW update
    written in place, the update in slices)."""
    monkeypatch.setattr(adam, "INPLACE_CHUNK", 1000)
    arch = "qwen3-moe-235b-a22b"
    tr = _port_trainer(arch)
    scfg = TrainStepConfig(policy_plan=tr.controller.plan,
                           pipeline=tr.pipeline_cfg, sync=tr.sync_cfg,
                           adam=tr.tcfg.adam, remat=False)
    batch = tr._device_batch(next(_data(arch)[1]))
    state = tr.state
    twin = tree.tree_map(torch.clone, state)
    plain, _ = make_train_step(tr.model, scfg, psum_mean=lambda x: x)(twin,
                                                                      batch)
    ids = [id(t) for t in tree.leaves(state["params"])]
    errs = [id(st.err) for st in state["comp"].values()]
    donated, _ = make_train_step(tr.model, scfg, psum_mean=lambda x: x,
                                 donate=True)(state, batch)
    assert [id(t) for t in tree.leaves(donated["params"])] == ids
    assert [id(st.err) for st in donated["comp"].values()] == errs
    for a, b in zip(tree.leaves(donated), tree.leaves(plain)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="guard"):
        make_train_step(tr.model, dataclasses.replace(
            scfg, guard_nonfinite=True), donate=True)
