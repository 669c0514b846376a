"""Compressor parity: the port's PowerSGD round (2-D, 3-D and folded >3-D,
with and without the kernel path), its bucketed executor and its
collective schedule against the reference, fed the same gradients and the
same warm-start Q. Q is compared only up to column sign (QR sign choices
may differ); ghat and the EF residual are compared directly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import GPT2_FIDELITY as REF_GPT2_FIDELITY
from repro.core import bucketing as ref_bucketing
from repro.core import compressor as ref_comp
from repro.core import entropy as ref_entropy
from repro.core import powersgd as ref_psgd
from repro.models.model import build_model as ref_build_model

from repro_torch import tree
from repro_torch.configs.gpt2 import GPT2_FIDELITY
from repro_torch.core import bucketing, compressor, entropy, powersgd
from repro_torch.models.model import build_model

# fp32: rtol 1e-5, and atol 1e-6 per unit of the array's largest magnitude.
# A flat atol of 1e-6 sits below the rounding of one 256-long fp32 dot
# product at unit scale (about 1e-6 when XLA and torch sum in other orders).
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol * scale)


def _close_up_to_sign(got, want, rtol=RTOL, atol=ATOL):
    """Columns (last axis) agree up to a sign per column and slice."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    dots = np.sum(got * want, axis=-2, keepdims=True)
    _close(got * np.where(dots < 0, -1.0, 1.0), want, rtol, atol)


def _run_both(shape, rank, use_kernels, steps=2):
    g_np = [_np(shape, 10 + i) for i in range(steps)]
    q_np = _np(tuple(shape[:-2]) + (shape[-1], rank), 1)
    e_np = _np(shape, 2, 0.1)
    ref_st = ref_psgd.LowRankState(q=jnp.asarray(q_np), err=jnp.asarray(e_np))
    st = powersgd.LowRankState(q=torch.from_numpy(q_np), err=torch.from_numpy(e_np))
    for g in g_np:
        ref_out, ref_st = ref_psgd.compress_leaf(jnp.asarray(g), ref_st,
                                                 use_kernels=use_kernels)
        out, st = powersgd.compress_leaf(torch.from_numpy(g), st,
                                         use_kernels=use_kernels)
        assert out.shape == g.shape and st.q.shape == ref_st.q.shape
        _close(out, ref_out)
        _close(st.err, ref_st.err)
        _close_up_to_sign(st.q, ref_st.q, rtol=1e-4, atol=1e-4)
    return out, st


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("shape,rank", [
    ((128, 256), 8),            # 2-D leaf
    ((3, 128, 256), 4),         # (E, m, n) stack
    ((2, 2, 128, 128), 8),      # >3-D leaf, folded to one batch dim
    ((96, 200), 6),             # untileable on the TPU: the reference's oracle
])
def test_compress_leaf_matches_reference(shape, rank, use_kernels):
    _run_both(shape, rank, use_kernels)


def test_kernel_and_plain_paths_agree():
    """Gram-Schmidt (kernel path) and QR (plain path) span the same
    columns, so ghat and EF agree between the two paths of the port."""
    shape = (2, 128, 256)
    g = torch.from_numpy(_np(shape, 3))
    st = powersgd.LowRankState(q=torch.from_numpy(_np((2, 256, 8), 4)),
                               err=torch.zeros(shape))
    out_k, st_k = powersgd.compress_leaf(g, st, use_kernels=True)
    out_p, st_p = powersgd.compress_leaf(g, st, use_kernels=False)
    _close(out_k, out_p, 1e-4, 1e-5)
    _close(st_k.err, st_p.err, 1e-4, 1e-5)
    _close_up_to_sign(st_k.q, st_p.q, 1e-4, 1e-4)


def test_resize_rank_keeps_leading_columns_and_ef():
    st = powersgd.init_leaf_state((64, 96), 8, seed=5)
    small = powersgd.resize_rank(st, 4, seed=6)
    big = powersgd.resize_rank(st, 12, seed=6)
    assert torch.equal(small.q, st.q[:, :4]) and torch.equal(big.q[:, :8], st.q)
    assert big.q.shape == (96, 12) and small.err is st.err
    assert powersgd.compressed_bytes((3, 64, 96), 8) == \
        ref_psgd.compressed_bytes((3, 64, 96), 8)


# ----------------------------------------------------------- the gpt2 tree
def _gpt2_setup():
    """gpt2-fidelity leaves, the fixed rank-8 plan of
    ``benchmarks/sync_bucketing.py``, seeded gradients and warm starts."""
    shapes = jax.eval_shape(ref_build_model(REF_GPT2_FIDELITY).init,
                            jax.random.PRNGKey(0))
    ref_leaves = ref_comp.classify_leaves(shapes, REF_GPT2_FIDELITY.num_layers,
                                          4, min_dim=64)
    ref_plan = ref_comp.make_plan("fixed", ref_leaves, fixed_rank=8)
    params = build_model(GPT2_FIDELITY).init(0, "cpu")
    leaves = compressor.classify_leaves(params, GPT2_FIDELITY.num_layers, 4,
                                        min_dim=64)
    plan = compressor.make_plan("fixed", leaves, fixed_rank=8)
    assert plan.ranks == ref_plan.ranks
    flat = tree.flatten_with_path(params)
    g_np = {p: _np(tuple(t.shape), 100 + i) for i, (p, t) in enumerate(flat)}
    q_np = {p: _np(tuple(by.shape[:-2]) + (by.shape[-1], r), 200 + i)
            for i, (p, r) in enumerate(plan.ranks)
            for by in [dict(flat)[p]]}
    grads = tree.unflatten(params, [torch.from_numpy(g_np[p]) for p, _ in flat])
    ref_grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jnp.asarray(g_np[p]) for p, _ in flat])
    per_leaf = {p: powersgd.LowRankState(q=torch.from_numpy(q_np[p]),
                                         err=torch.zeros(dict(flat)[p].shape))
                for p, _ in plan.ranks}
    ref_per_leaf = {p: ref_psgd.LowRankState(q=jnp.asarray(q_np[p]),
                                             err=jnp.zeros(dict(flat)[p].shape))
                    for p, _ in plan.ranks}
    return (leaves, plan, grads, per_leaf), (ref_leaves, ref_plan, ref_grads,
                                             ref_per_leaf)


class _Counting:
    """An identity psum_mean that counts its calls (one per collective)."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return x


@pytest.mark.parametrize("bucketed,want", [(True, 7), (False, 76)])
def test_collective_counts_match_reference(bucketed, want):
    (leaves, plan, grads, per_leaf), (ref_leaves, ref_plan, ref_grads,
                                      ref_per_leaf) = _gpt2_setup()
    layout = bucketing.make_bucket_layout(leaves, plan)
    ref_layout = ref_bucketing.make_bucket_layout(ref_leaves, ref_plan)
    assert layout.num_collectives() == ref_layout.num_collectives() == 7
    state = bucketing.stack_state(per_leaf, layout) if bucketed else per_leaf
    ref_state = (ref_bucketing.stack_state(ref_per_leaf, ref_layout)
                 if bucketed else ref_per_leaf)
    port_count, ref_count = _Counting(), _Counting()
    synced, _ = compressor.sync_grads(grads, state, plan, port_count,
                                      bucketed=bucketed)
    ref_synced, _ = ref_comp.sync_grads(ref_grads, ref_state, ref_plan,
                                        ref_count, bucketed=bucketed)
    assert port_count.calls == ref_count.calls == want
    ref_flat = jax.tree_util.tree_leaves(ref_synced)
    for (path, got), want_leaf in zip(tree.flatten_with_path(synced), ref_flat):
        _close(got, want_leaf, 1e-5, 1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_bucketed_equals_per_leaf(use_kernels):
    """Stacking shape groups changes the schedule, not the numbers."""
    (leaves, plan, grads, per_leaf), (_, ref_plan, ref_grads,
                                      ref_per_leaf) = _gpt2_setup()
    layout = bucketing.make_bucket_layout(leaves, plan)
    synced_b, st_b = bucketing.bucketed_sync_grads(
        grads, bucketing.stack_state(per_leaf, layout), layout, lambda x: x,
        use_kernels=use_kernels)
    synced_l, st_l = compressor.sync_grads(grads, per_leaf, plan, lambda x: x,
                                           use_kernels=use_kernels,
                                           bucketed=False)
    for (p, a), (_, b) in zip(tree.flatten_with_path(synced_b),
                              tree.flatten_with_path(synced_l)):
        _close(a, b, 1e-5, 1e-5)
    unstacked = bucketing.unstack_state(st_b, layout)
    for path, st in st_l.items():
        _close(unstacked[path].err, st.err, 1e-5, 1e-5)
        _close_up_to_sign(unstacked[path].q, st.q, 1e-4, 1e-4)
    # and against the reference's per-leaf oracle
    ref_synced, _ = ref_comp.sync_grads(ref_grads, ref_per_leaf, ref_plan,
                                        lambda x: x, use_kernels=use_kernels,
                                        bucketed=False)
    for (p, a), b in zip(tree.flatten_with_path(synced_b),
                         jax.tree_util.tree_leaves(ref_synced)):
        _close(a, b, 1e-5, 1e-5)


def test_resize_stacked_state_keeps_warm_starts():
    (leaves, plan, grads, per_leaf), _ = _gpt2_setup()
    old = bucketing.make_bucket_layout(leaves, plan)
    stacked = bucketing.stack_state(per_leaf, old)
    plan2 = compressor.make_plan("edgc", leaves, stage_ranks=[4, 8, 12, 16],
                                 num_stages=4)
    new = bucketing.make_bucket_layout(leaves, plan2)
    moved = compressor.resize_compressor_state(stacked, plan2, seed=7,
                                               old_layout=old, new_layout=new)
    back = bucketing.unstack_state(moved, new)
    for path, rank in plan2.ranks:
        q0 = per_leaf[path].q
        keep = min(rank, q0.shape[-1])
        assert back[path].q.shape[-1] == rank
        assert torch.equal(back[path].q[..., :keep], q0[..., :keep])


def test_grads_entropy_matches_reference():
    (_, _, grads, _), (_, _, ref_grads, _) = _gpt2_setup()
    for alpha, beta in [(0.5, 0.25), (1.0, 1.0)]:
        cfg = entropy.GDSConfig(alpha=alpha, beta=beta)
        ref_cfg = ref_entropy.GDSConfig(alpha=alpha, beta=beta)
        got = float(entropy.grads_entropy(grads, cfg))
        want = float(ref_entropy.grads_entropy(ref_grads, ref_cfg))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    x = _np((4096,), 9)
    _close(entropy.histogram_entropy(torch.from_numpy(x)),
           ref_entropy.histogram_entropy(jnp.asarray(x)), 1e-4, 1e-4)


@pytest.mark.parametrize("chunk_bytes", [0, 4096, 1 << 18])
def test_sync_chunks_match_reference(chunk_bytes):
    """The launchable chunks of a layout (shape groups whole, flat buckets
    split at ``chunk_bytes``) are the reference's, in the same order."""
    (leaves, plan, _, _), (ref_leaves, ref_plan, _, _) = _gpt2_setup()
    layout = bucketing.make_bucket_layout(leaves, plan, chunk_bytes=chunk_bytes)
    ref_layout = ref_bucketing.make_bucket_layout(ref_leaves, ref_plan,
                                                  chunk_bytes=chunk_bytes)
    describe = lambda cs: [(c.kind, c.group.key if c.group else None,
                            c.members, c.itemsizes, c.num_collectives)
                           for c in cs]
    got = describe(bucketing.sync_chunks(layout))
    assert got == describe(ref_bucketing.sync_chunks(ref_layout))
    assert sum(c[-1] for c in got) >= layout.num_collectives()
