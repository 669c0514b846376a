"""The overlapped per-stage sync of the port against the reference's: the
planner (sync ticks after each stage's last backward), chunked sync
against the monolithic bucketed sync, the chunk wire ledger, the config
surface, the SyncExecutor's modes, the DAC's overlap feedback, the
overlapped step at S = 4 against the monolithic step, the overlapped 1F1B
trainer on a ``(pipe=2, data=2)`` mesh of four gloo processes against a
flat ``data=2`` run, and the overlapped trainer against the reference's on
four fake devices. Port of ``tests/test_overlap.py``, test for test.

Bars, the reference tests' own: chunked sync equal to monolithic bit for
bit (raw and quant8, any chunk order); the overlapped step equal to the
monolithic step bit for bit; the mesh run's losses within 5e-3 of the
flat run's; against the reference trainer, losses within 5e-3, entropy
within 1e-4, bytes and stage bytes and the ``overlap_plan`` event equal.
Between the two packages, the chunk outputs at ``test_torch_pipeline.py``'s
fp32 bars (rtol 1e-5, atol 1e-6 per unit of the largest magnitude; Q up to
column sign at 1e-4), coded payloads pinned to the reference's by its
``_Replay`` rule; plans, ranks and ledgers equal exactly.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core import CommModel as RefCommModel
from repro.core import CompressionPlan as RefPlan
from repro.core import LeafInfo as RefLeafInfo
from repro.core import bucketing as ref_bucketing
from repro.core import comm_model as ref_comm
from repro.core import compressor as ref_comp
from repro.core import wire as ref_wire
from repro.core.cqm import CQM as RefCQM
from repro.core.dac import DAC as RefDAC
from repro.core.dac import DACConfig as RefDACConfig
from repro.core.dac import stage_aligned_ranks as ref_stage_aligned_ranks
from repro.launch.report import build_report as ref_build_report
from repro.models.model import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro.pipeline import schedule as ref_sched
from repro.pipeline.sync import make_stage_plans as ref_make_stage_plans

from repro_torch import tree
from repro_torch.core import (CommModel, CompressionPlan, EDGCConfig,
                              GDSConfig, LeafInfo, NO_COMPRESSION, SyncConfig,
                              bucketing, classify_leaves, make_plan,
                              sync_grads, wire)
from repro_torch.core.bucketing import make_bucket_layout, sync_chunks
from repro_torch.core.comm_model import HardwareSpec
from repro_torch.core.cqm import CQM
from repro_torch.core.dac import DAC, DACConfig, stage_aligned_ranks
from repro_torch.core.powersgd import LowRankState
from repro_torch.core.sync_executor import SyncExecutor
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import to_tensor
from repro_torch.launch.report import build_report
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.obs import MemorySink, MetricsRegistry
from repro_torch.optim.adam import AdamConfig
from repro_torch.pipeline import PipelineConfig
from repro_torch.pipeline import schedule as sched
from repro_torch.pipeline.executor import LocalPipe
from repro_torch.pipeline.sync import make_stage_plans, stage_wire_bytes
from repro_torch.train.step import TrainStepConfig, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

from test_torch_pipeline import _close, _close_up_to_sign, _Replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(name="ovl", family="dense", num_layers=2, d_model=128,
            num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
            num_stages=2)
PLANS = {
    "none": {},
    "fixed": dict(fixed_rank=8),
    "optimus": dict(fixed_rank=8, num_stages=2),
    "edgc": dict(stage_ranks=[4, 16], num_stages=2),
}
DATA = dict(vocab_size=512, seq_len=32, batch_size=8, seed=3)


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _setup(policy="fixed"):
    """Both packages' TINY params (the reference's, seeded, carried across),
    leaves and plan for ``policy``."""
    ref_model = ref_build_model(RefModelConfig(**TINY))
    params_np = jax.device_get(ref_model.init(jax.random.PRNGKey(0)))
    params = tree.tree_map(to_tensor, params_np)
    ref_leaves = ref_comp.classify_leaves(params_np, 2, 2, min_dim=64)
    leaves = classify_leaves(params, 2, 2, min_dim=64)
    ref_plan = ref_comp.make_plan(policy, ref_leaves, **PLANS[policy])
    plan = make_plan(policy, leaves, **PLANS[policy])
    assert plan.ranks == ref_plan.ranks
    return params_np, params, ref_leaves, leaves, ref_plan, plan


def _stage_world(num_stages=2, chunk_bytes=0, ranks=(4, 16), ref=False):
    """Synthetic uniform-stage world with the ``['stages'][i]`` paths the
    adapters emit: per-stage local template [w, u, b, t], no shared
    leaves, stage s compressed at ``ranks[s]`` (the reference's with
    ``ref``)."""
    Info, Plan, make = ((RefLeafInfo, RefPlan, ref_make_stage_plans) if ref
                        else (LeafInfo, CompressionPlan, make_stage_plans))
    local = [("['w']", (64, 128)), ("['u']", (64, 128)),
             ("['b']", (128,)), ("['t']", (8192,))]
    g_ranks, infos = [], []
    for s in range(num_stages):
        for lp, shape in local:
            path = f"['stages'][{s}]{lp}"
            infos.append(Info(path=path, shape=shape, stage=s,
                              eligible=len(shape) == 2))
            if len(shape) == 2:
                g_ranks.append((path, ranks[s % len(ranks)]))
    plan = Plan(ranks=tuple(g_ranks))
    return make(plan, num_stages, local, chunk_bytes=chunk_bytes), infos, plan


def _plan_fields(p):
    return (p.launches, p.residual, p.slack_seconds, p.est_sync_seconds,
            p.feasible)


# ------------------------------------------------------------- the planner
@pytest.mark.parametrize("name", ["gpipe", "1f1b"])
@pytest.mark.parametrize("S,M", [(2, 2), (2, 8), (4, 4), (4, 16)])
def test_sync_ticks_strictly_after_last_backward(name, S, M):
    last_b = sched.last_backward_tick(name, S, M)
    ticks = sched.sync_ticks(name, S, M)
    n = sched.tick_count(name, S, M)
    table = sched.slot_table(name, S, M)
    assert last_b == ref_sched.last_backward_tick(name, S, M)
    assert ticks == ref_sched.sync_ticks(name, S, M)
    for s in range(S):
        assert all(last_b[s] < t < n for t in ticks[s])
        # the stage really is done at its recorded last backward
        assert any(k == "B" for k, _ in table[s][last_b[s]])
        assert all(k != "B" for t in range(last_b[s] + 1, n)
                   for k, _ in table[s][t])
        # the drain window is the Algorithm 2 slack
        assert len(ticks[s]) == sched.sync_slack_ticks(name, S, M)[s]


@pytest.mark.parametrize("name", ["gpipe", "1f1b"])
def test_plan_overlap_partitions_chunks_in_drain(name):
    S, M = 4, 8
    splans, _, _ = _stage_world(num_stages=S, chunk_bytes=4 << 10)
    plan = sched.plan_overlap(name, S, M, splans)
    ref_splans, _, _ = _stage_world(num_stages=S, chunk_bytes=4 << 10,
                                    ref=True)
    assert _plan_fields(plan) == _plan_fields(
        ref_sched.plan_overlap(name, S, M, ref_splans))
    last_b = sched.last_backward_tick(name, S, M)
    for s in range(S):
        n_chunks = len(sync_chunks(splans.layouts[splans.d_of_stage[s]]))
        launched = [ci for _, ids in plan.launches[s] for ci in ids]
        # every chunk launches exactly once: in the drain or after the loop
        assert sorted(launched + list(plan.residual[s])) == list(
            range(n_chunks))
        assert all(t > last_b[s] for t in plan.launch_ticks(s))
        assert set(plan.launch_ticks(s)) <= set(sched.sync_ticks(name, S, M)[s])
    # stage 0 has zero slack: its whole schedule runs after the loop
    assert plan.launches[0] == ()
    assert plan.slack_seconds[0] == 0.0
    assert plan.feasible == (True,) * S
    # in-loop plus residual collectives: one launch per chunk, and chunking
    # only ever adds launches over the monolithic count
    in_loop, residual = sched.overlap_branch_psums(plan, splans)
    assert (in_loop, residual) == ref_sched.overlap_branch_psums(
        ref_sched.plan_overlap(name, S, M, ref_splans), ref_splans)
    totals = list(residual)
    for _, counts in in_loop:
        totals = [a + b for a, b in zip(totals, counts)]
    chunk_bill = tuple(
        sum(c.num_collectives
            for c in sync_chunks(splans.layouts[splans.d_of_stage[s]]))
        for s in range(S))
    assert tuple(totals) == chunk_bill
    assert all(c >= p for c, p in
               zip(chunk_bill, splans.predicted_collectives()))


def test_plan_overlap_feasibility_with_comm_model():
    S, M = 4, 8
    splans, _, _ = _stage_world(num_stages=S)
    ref_splans, _, _ = _stage_world(num_stages=S, ref=True)
    hw = HardwareSpec(**dataclasses.asdict(ref_comm.TPU_V5E))
    comm = CommModel.from_shapes([(128, 256)] * 8, world=4, hw=hw)
    plan = sched.plan_overlap("1f1b", S, M, splans, comm=comm)
    ref_plan = ref_sched.plan_overlap(
        "1f1b", S, M, ref_splans,
        comm=RefCommModel.from_shapes([(128, 256)] * 8, world=4))
    assert _plan_fields(plan) == _plan_fields(ref_plan)
    sim = sched.simulate_schedule("1f1b", S, M)
    assert plan.slack_seconds == tuple(float(t) for t in
                                       sim["slack_seconds"])
    for s in range(S):
        assert plan.est_sync_seconds[s] > 0
        assert plan.feasible[s] == (
            plan.est_sync_seconds[s]
            <= plan.est_sync_seconds[0] + plan.slack_seconds[s] + 1e-9)


def test_slot_table_carries_sync_entries():
    S, M = 4, 8
    splans, _, _ = _stage_world(num_stages=S, chunk_bytes=4 << 10)
    plan = sched.plan_overlap("1f1b", S, M, splans)
    table = sched.slot_table("1f1b", S, M, sync_plan=plan)
    ref_splans, _, _ = _stage_world(num_stages=S, chunk_bytes=4 << 10,
                                    ref=True)
    assert table == ref_sched.slot_table(
        "1f1b", S, M, sync_plan=ref_sched.plan_overlap("1f1b", S, M,
                                                       ref_splans))
    last_b = sched.last_backward_tick("1f1b", S, M)
    for s in range(S):
        seen = sorted(ci for acts in table[s] for k, ci in acts if k == "S")
        launched = sorted(ci for _, ids in plan.launches[s] for ci in ids)
        assert seen == launched
        for t, acts in enumerate(table[s]):
            if any(k == "S" for k, _ in acts):
                assert t > last_b[s]


# --------------------------------------------------- chunked sync parity
def _port_state(ref_state):
    """A reference compressor state (numpy) as the port's tensors."""
    return {k: (LowRankState(q=to_tensor(v.q), err=to_tensor(v.err))
                if isinstance(v, tuple) else to_tensor(v))
            for k, v in ref_state.items()}


@pytest.mark.parametrize("coded", [False, True], ids=["raw", "quant8"])
@pytest.mark.parametrize("chunk_bytes", [0, 16 << 10])
@pytest.mark.parametrize("policy", ["none", "fixed", "optimus", "edgc"])
def test_chunked_reassembly_matches_monolithic(policy, chunk_bytes, coded):
    """Running every chunk, in any order, reproduces the monolithic
    bucketed sync bit for bit (grads, EF residual, warm-start Q and the
    coded wire's ``ef:`` residuals) for all four policies; each chunk
    agrees with the reference's chunk."""
    params_np, params, ref_leaves, leaves, ref_plan, plan = _setup(policy)
    mono_layout = make_bucket_layout(leaves, plan)
    layout = make_bucket_layout(leaves, plan, chunk_bytes=chunk_bytes)
    chunks = sync_chunks(layout)
    ref_chunks = ref_bucketing.sync_chunks(ref_bucketing.make_bucket_layout(
        ref_leaves, ref_plan, chunk_bytes=chunk_bytes))
    assert [(c.kind, c.member_paths) for c in chunks] == \
        [(c.kind, c.member_paths) for c in ref_chunks]
    n_mono = len(mono_layout.groups) + len(mono_layout.buckets)
    if chunk_bytes:       # the tiny cap really splits the flat buckets
        assert len(chunks) > n_mono
    else:
        assert len(chunks) == n_mono

    rng = np.random.default_rng(0)
    grads_np = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params_np)
    grads = tree.tree_map(to_tensor, grads_np)
    ref_state = jax.device_get(ref_comp.init_compressor_state(
        params_np, ref_plan, jax.random.PRNGKey(1),
        layout=ref_bucketing.make_bucket_layout(ref_leaves, ref_plan),
        wire_ef=coded))
    if coded:        # nonzero residuals, so that the EF path is exercised
        ref_state = {k: (v if isinstance(v, tuple) else
                         rng.standard_normal(v.shape).astype(np.float32) * 1e-2)
                     for k, v in ref_state.items()}
    state = _port_state(ref_state)
    ident = lambda x: x
    codec = wire.resolve_codec("quant8") if coded else None
    ref_codec = ref_wire.resolve_codec("quant8") if coded else None
    s_ref, st_ref = sync_grads(grads, dict(state), plan, ident,
                               bucketed=True, codec=codec)

    by_path = dict(tree.flatten_with_path(grads))
    ref_by_path = {jax.tree_util.keystr(kp): g for kp, g in
                   jax.tree_util.tree_flatten_with_path(grads_np)[0]}
    upd_all, st_new = {}, dict(state)
    for ci in rng.permutation(len(chunks)):
        chunk, ref_chunk = chunks[ci], ref_chunks[ci]
        hooks = _Replay(codec)
        ref_psum, psum = (hooks.record, hooks.replay) if coded else (ident,
                                                                     ident)
        gb = {p: by_path[p] for p in chunk.member_paths}
        upd, st_d = bucketing.sync_chunk_grads(gb, state, chunk, ident,
                                               codec=codec)
        upd_all.update(upd)
        st_new.update(st_d)
        # the reference's chunk on the same numbers
        want, want_st = ref_bucketing.sync_chunk_grads(
            {p: ref_by_path[p] for p in chunk.member_paths}, ref_state,
            ref_chunk, ref_psum, codec=ref_codec)
        got, got_st = bucketing.sync_chunk_grads(gb, state, chunk, psum,
                                                 codec=codec)
        assert set(got) == set(want) and set(got_st) == set(want_st)
        for p in got:
            _close(got[p].numpy(), np.asarray(want[p]))
        for k, v in got_st.items():
            if isinstance(v, LowRankState):
                _close(v.err.numpy(), np.asarray(want_st[k].err))
                _close_up_to_sign(v.q.numpy(), np.asarray(want_st[k].q))
            else:
                _close(v.numpy(), np.asarray(want_st[k]))

    flat_ref = tree.flatten_with_path(s_ref)
    assert set(upd_all) == {p for p, _ in flat_ref}
    for p, ref in flat_ref:
        assert torch.equal(ref, upd_all[p]), p
    assert set(st_new) == set(st_ref)
    for key in st_ref:
        for a, b in zip(tree.leaves(st_ref[key]), tree.leaves(st_new[key])):
            assert torch.equal(a, b), key


def test_chunk_wire_ledger_matches_plan_ranks():
    """Per-stage chunk wire bytes equal the Algorithm 2 ledger's compressed
    bytes, and every group chunk carries exactly its plan rank."""
    splans, leaves, plan = _stage_world(num_stages=2)
    ledger = stage_wire_bytes(leaves, plan, 2, bytes_per_elem=4)
    _, ref_leaves, ref_plan = _stage_world(num_stages=2, ref=True)
    from repro.pipeline.sync import stage_wire_bytes as ref_stage_wire_bytes
    assert ledger == ref_stage_wire_bytes(ref_leaves, ref_plan, 2,
                                          bytes_per_elem=4)
    for s in range(2):
        sp = splans.stage_plans[s]
        chunks = sync_chunks(splans.layouts[splans.d_of_stage[s]])
        for c in chunks:
            if c.kind == "group":
                for p in c.member_paths:
                    assert sp.rank_of(p) == c.group.rank
        assert sum(c.wire_bytes() for c in chunks) == ledger[s][0]


# ----------------------------------------------------- the config surface
def _adam(steps=4):
    return AdamConfig(lr=1e-3, warmup_steps=1, total_steps=steps)


def test_step_config_legacy_shim():
    cfg = TrainStepConfig(mode="dp_tp", policy_plan=NO_COMPRESSION,
                          num_stages=2, schedule="gpipe",
                          num_microbatches=4, use_kernels=True)
    assert cfg.pipeline == PipelineConfig(num_stages=2, schedule="gpipe",
                                          num_microbatches=4)
    assert cfg.sync == SyncConfig(use_kernels=True)
    # flat aliases read through to the embedded configs
    assert cfg.num_stages == 2 and cfg.schedule == "gpipe"
    assert cfg.use_kernels is True and cfg.overlap_sync is False
    hash(cfg)
    r = dataclasses.replace(cfg, pipeline=PipelineConfig(num_stages=3))
    assert r.num_stages == 3 and r.sync is cfg.sync
    with pytest.raises(TypeError):
        TrainStepConfig(mode="dp_tp", policy_plan=NO_COMPRESSION,
                        not_a_knob=1)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.remat = False


def test_embedded_configs_pass_by_identity():
    pcfg = PipelineConfig(num_stages=3, overlap_sync=True, chunk_bytes=256)
    scfg = SyncConfig(use_kernels=True, bucket_bytes=1 << 20)
    step = TrainStepConfig(mode="dp_tp", policy_plan=NO_COMPRESSION,
                           pipeline=pcfg, sync=scfg)
    assert step.pipeline is pcfg and step.sync is scfg
    assert step.overlap_sync is True and step.chunk_bytes == 256
    edgc = EDGCConfig(policy="fixed", fixed_rank=8, pipeline=pcfg, sync=scfg)
    assert edgc.pipeline is pcfg and edgc.num_stages == 3
    tcfg = TrainerConfig(total_steps=2, pipeline=pcfg, sync=scfg,
                         adam=_adam())
    assert tcfg.pipeline is pcfg and tcfg.sync is scfg
    # a legacy override forces a copy, never a mutation
    step2 = TrainStepConfig(mode="dp_tp", policy_plan=NO_COMPRESSION,
                            pipeline=pcfg, num_stages=5)
    assert step2.pipeline is not pcfg and step2.num_stages == 5
    assert pcfg.num_stages == 3


def test_trainer_config_aliases_are_settable():
    tcfg = TrainerConfig(total_steps=2, adam=_adam())
    assert tcfg.pipeline == PipelineConfig() and tcfg.sync == SyncConfig()
    tcfg.schedule = "gpipe"
    tcfg.overlap_sync = True
    tcfg.bucket_bytes = 1 << 16
    assert tcfg.pipeline.schedule == "gpipe"
    assert tcfg.pipeline.overlap_sync is True
    assert tcfg.sync.bucket_bytes == 1 << 16
    with pytest.raises(TypeError):
        TrainerConfig(total_steps=2, adam=_adam(), bogus=3)


@pytest.mark.parametrize("pipe", [None, 2], ids=["flat", "pipelined"])
def test_trainer_and_step_builder_share_one_pipeline_config(pipe):
    """The Trainer hands the step builder the identical PipelineConfig and
    SyncConfig objects it resolved, not copied fields; on the pipelined
    path with ``overlap_sync`` too."""
    S = pipe or 1
    model = build_model(ModelConfig(**dict(TINY, num_stages=S)))
    pcfg = PipelineConfig(num_stages=S, overlap_sync=pipe is not None)
    edgc = EDGCConfig(policy="fixed", fixed_rank=8, total_iterations=4,
                      pipeline=pcfg)
    tcfg = TrainerConfig(total_steps=4, pipeline=pcfg, adam=_adam())
    tr = Trainer(model, edgc, tcfg, seed=0, device="cpu", pipe=pipe)
    assert tr.pipeline_cfg is pcfg
    tr._get_step(False)
    assert tr.step_configs, "step builds must record their configs"
    for scfg in tr.step_configs.values():
        assert scfg.pipeline is tr.pipeline_cfg
        assert scfg.sync is tr.sync_cfg


def test_sync_executor_validates_mode_and_plans():
    splans, _, plan = _stage_world()
    with pytest.raises(ValueError):
        SyncExecutor(SyncConfig(), mode="carrier-pigeon")
    with pytest.raises(ValueError):
        SyncExecutor(SyncConfig(), mode="flat")            # needs a plan
    with pytest.raises(ValueError):
        SyncExecutor(SyncConfig(), mode="per-stage")       # needs splans
    SyncExecutor(SyncConfig(), mode="flat", plan=plan)
    ex = SyncExecutor(SyncConfig(), mode="per-stage-overlapped",
                      splans=splans)
    assert ex.chunks(0) == sync_chunks(splans.layouts[0])


# ------------------------------------------------------- DAC overlap hook
def _dac(num_stages=4, ref=False):
    """The reference's DAC fixture, in either package, on the same
    hardware numbers (the reference's spec, field for field)."""
    if ref:
        comm = RefCommModel.from_shapes([(1024, 4096)] * 24, world=16)
        return RefDAC(cqm=RefCQM(m=256, n=1024), comm=comm,
                      cfg=RefDACConfig(window=100, adjust_limit=4),
                      r_min=8, r_max=64, num_stages=num_stages,
                      t_micro_back=comm.t_com(4), total_iterations=1000)
    hw = HardwareSpec(**dataclasses.asdict(ref_comm.TPU_V5E))
    comm = CommModel.from_shapes([(1024, 4096)] * 24, world=16, hw=hw)
    return DAC(cqm=CQM(m=256, n=1024), comm=comm,
               cfg=DACConfig(window=100, adjust_limit=4),
               r_min=8, r_max=64, num_stages=num_stages,
               t_micro_back=comm.t_com(4), total_iterations=1000)


def test_stage_aligned_ranks_slack_degenerates_to_analytic():
    comm = _dac().comm
    t_mb = comm.t_com(4)
    base = stage_aligned_ranks(16, 4, comm, t_mb, 8, 64)
    unit = stage_aligned_ranks(16, 4, comm, t_mb, 8, 64,
                               slack_seconds=[s * t_mb for s in range(4)])
    assert base == unit
    ref = _dac(ref=True).comm
    assert unit == ref_stage_aligned_ranks(
        16, 4, ref, ref.t_com(4), 8, 64,
        slack_seconds=[s * ref.t_com(4) for s in range(4)])


def test_dac_set_overlap_validates():
    dac = _dac()
    with pytest.raises(ValueError):
        dac.set_overlap([0.0, 1.0])                 # wrong stage count
    with pytest.raises(ValueError):
        dac.set_overlap([0.0, -1.0, 1.0, 2.0])      # negative slack
    dac.set_overlap([0.0, 1e-4, 2e-4, 3e-4])
    assert dac.slack_seconds == [0.0, 1e-4, 2e-4, 3e-4]


def test_dac_feasibility_clamp_trades_rank_for_overlap():
    free, tight, loose = _dac(), _dac(), _dac()
    tight.set_overlap([0.0] * 4)        # no drain to hide behind at all
    r_free = free.current_ranks()
    r_tight = tight.current_ranks()
    assert all(a <= b for a, b in zip(r_tight, r_free))
    # zero slack leaves no room for a larger late-stage rank: every
    # stage's comm must fit stage 1's window
    t1 = tight.comm.t_com(r_tight[0])
    assert all(tight.comm.t_com(r) <= t1 + 1e-12 or r == tight.r_min
               for r in r_tight)
    # generous slack changes nothing against the analytic head start
    loose.set_overlap([0.0, 1.0, 2.0, 3.0])
    assert loose.current_ranks() == r_free
    # the reference's DACs give the same rank vectors
    ref_tight, ref_loose = _dac(ref=True), _dac(ref=True)
    ref_tight.set_overlap([0.0] * 4)
    ref_loose.set_overlap([0.0, 1.0, 2.0, 3.0])
    assert r_free == _dac(ref=True).current_ranks()
    assert r_tight == ref_tight.current_ranks()
    assert loose.current_ranks() == ref_loose.current_ranks()


def test_controller_overlap_feedback_reaches_the_dac():
    """``EDGCController.set_overlap_feedback`` feeds ``DAC.set_overlap``;
    an overlapped pipelined trainer hands it the planner's slack times the
    DAC's microbatch backward, as the reference's trainer does."""
    S = 2
    model = build_model(ModelConfig(**dict(TINY, num_stages=S)))
    tr = Trainer(model, EDGCConfig(policy="edgc", num_stages=S,
                                   total_iterations=4),
                 TrainerConfig(total_steps=4, overlap_sync=True,
                               num_microbatches=4, adam=_adam()),
                 seed=0, device="cpu", pipe=S)
    t_mb = tr.controller.dac.t_micro_back
    assert tr.controller.dac.slack_seconds == [
        t * t_mb for t in tr.overlap_plan.slack_seconds]
    tr.controller.set_overlap_feedback([0.0, 1.0])
    assert tr.controller.dac.slack_seconds == [0.0, 1.0]
    with pytest.raises(ValueError):
        tr.controller.set_overlap_feedback([0.0])


# ------------------------------------- the overlapped step against the plan
class _CountingPipe(LocalPipe):
    """A LocalPipe that counts the ticks it delivers."""

    def __init__(self, num_stages):
        super().__init__(num_stages)
        self.tick = 0

    def deliver(self, expect, spec, device):
        super().deliver(expect, spec, device)
        self.tick += 1


@pytest.mark.parametrize("schedule,wire_mode", [
    ("1f1b", "raw"), ("gpipe", "raw"), ("1f1b", "quant8")])
def test_overlapped_step_equals_monolithic_at_the_planned_ticks(
        schedule, wire_mode, monkeypatch):
    """S = 4, M = 4, eight layers, flat buckets split into several chunks:
    three overlapped steps equal three monolithic ones bit for bit (losses,
    metrics, parameters, optimizer and compressor state); each in-loop
    ``run_chunks`` call happens at the tick ``plan_overlap`` gives it, and
    the residual chunks after the loop."""
    S, M, steps = 4, 4, 3
    cfg = ModelConfig(**dict(TINY, num_layers=8, num_stages=S))

    def trainer(overlap):
        return Trainer(
            build_model(cfg),
            EDGCConfig(policy="fixed", fixed_rank=8, num_stages=S,
                       total_iterations=steps),
            TrainerConfig(total_steps=steps, schedule=schedule,
                          num_microbatches=M, overlap_sync=overlap,
                          chunk_bytes=1 << 14, wire=wire_mode,
                          adam=_adam(steps)),
            seed=0, device="cpu", pipe=S)

    calls = []
    real = SyncExecutor.run_chunks

    def counted(self, d, ids, *a, **k):
        calls.append((pipe.tick, tuple(ids)))
        return real(self, d, ids, *a, **k)

    monkeypatch.setattr(SyncExecutor, "run_chunks", counted)
    runs = {}
    for overlap in (False, True):
        tr = trainer(overlap)
        pipe = _CountingPipe(S)
        scfg = TrainStepConfig(policy_plan=tr.controller.plan,
                               gds=tr.edgc_cfg.gds, pipeline=tr.pipeline_cfg,
                               sync=tr.sync_cfg, adam=tr.tcfg.adam)
        step = make_train_step(tr.model, scfg, psum_mean=lambda x: x,
                               pipe=pipe)
        state, mets = tr.state, []
        data = SyntheticLM(**DATA).batches()
        for _ in range(steps):
            batch = {k: torch.as_tensor(v).long() for k, v in
                     next(data).items()}
            calls.clear()
            pipe.tick = 0
            state, m = step(state, batch)
            mets.append(m)
        runs[overlap] = (state, mets, list(calls), step.sync_launches, tr)
    (s0, m0, c0, l0, _), (s1, m1, c1, l1, tr) = runs[False], runs[True]
    assert c0 == [] and l0 == ()
    for a, b in zip(m0, m1):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(tree.leaves(s0), tree.leaves(s1), strict=True):
        assert torch.equal(a, b)

    plan = tr.overlap_plan
    n_ticks = sched.tick_count(schedule, S, M)
    in_loop = [(t, s, ids) for t, s, ids in l1 if t >= 0]
    for s in range(S):
        assert tuple((t, ids) for t, s_, ids in in_loop if s_ == s) == \
            plan.launches[s]
        assert [ids for t, s_, ids in l1 if t < 0 and s_ == s] == \
            [plan.residual[s]]
    # each run_chunks call: in-loop ones during their planned tick (before
    # its delivery), residual ones after the last tick
    assert [ids for _, ids in c1] == [ids for _, _, ids in l1]
    for (tick, _), (t, _, _) in zip(c1, l1):
        assert tick == (t if t >= 0 else n_ticks)
    assert sum(len(ids) for _, _, ids in in_loop) == sum(
        len(ids) for s in range(S) for _, ids in plan.launches[s]) > 0


# ------------------------------ the overlapped trainer on a gloo (pipe, data) mesh
_MESH = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    from test_torch_overlap import _mesh_run
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    res = _mesh_run()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
""")


def _mesh_trainer(mesh, overlap=False, stages=2, **tkw):
    """The reference test's run: 4 layers, optimus rank 8, 1F1B, M = 4,
    chunks of 64 KiB, six steps."""
    S = 2
    cfg = ModelConfig(**dict(TINY, name="ovl4", num_layers=4, num_stages=S))
    pcfg = PipelineConfig(num_stages=stages, schedule="1f1b",
                          num_microbatches=4, overlap_sync=overlap,
                          chunk_bytes=1 << 16)
    edgc = EDGCConfig(policy="optimus", fixed_rank=8, total_iterations=6,
                      gds=GDSConfig(alpha=1.0, beta=0.25),
                      dac=DACConfig(window=5, adjust_limit=4), pipeline=pcfg)
    tcfg = TrainerConfig(total_steps=6, log_every=1, pipeline=pcfg,
                         adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=6), **tkw)
    return Trainer(build_model(cfg), edgc, tcfg, seed=0, device="cpu",
                   pipe=S if stages > 1 else None, mesh=mesh)


def _mesh_run():
    """In each of four gloo processes: the overlapped 1F1B trainer on a
    (pipe=2, data=2) mesh and the flat trainer over the process's data
    group (each row of the mesh runs one flat data=2 replica)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.pipeline.adapters import local_leaf_path
    S = 2
    mesh = make_host_mesh(pipe=S, data=2, device_type="cpu")
    data = lambda: SyntheticLM(**DATA).batches()
    to = _mesh_trainer(mesh, overlap=True)
    tf = _mesh_trainer(mesh["data"], stages=1)
    lo = [h["loss"] for h in to.run(data())]
    lf = [h["loss"] for h in tf.run(data())]
    op = to.overlap_plan
    # wire ledger: the chunks the overlapped executor moves per stage, plus
    # the shared leaves charged to that stage (moved uncompressed by
    # sync_shared_grads), sum to the Algorithm 2 ledger's compressed bytes
    plan = to.controller.plan
    ledger = stage_wire_bytes(to.leaves, plan, S, bytes_per_elem=4)
    shared_b = [0] * S
    for info in to.leaves:
        if local_leaf_path(info.path) is None:
            shared_b[min(info.stage, S - 1)] += int(np.prod(info.shape)) * 4
    moved, ranks_ok = [], True
    for s in range(S):
        sp = to._splans.stage_plans[s]
        chunks = sync_chunks(to._splans.layouts[to._splans.d_of_stage[s]])
        ranks_ok &= all(sp.rank_of(p) == c.group.rank for c in chunks
                        if c.kind == "group" for p in c.member_paths)
        moved.append(sum(c.wire_bytes() for c in chunks))
    return {"lo": lo, "lf": lf, "feasible": list(op.feasible),
            "in_loop": sum(len(ids) for s in range(S)
                           for _, ids in op.launches[s]),
            "slack": to.controller.dac.slack_seconds,
            "moved": moved, "shared": shared_b,
            "ledger": [c for c, _ in ledger], "ranks_ok": ranks_ok,
            "stage": to._transport.stage, "dp_rank": to.rank,
            "world": to.world}


def test_make_host_mesh_refuses_the_axes_of_item_12():
    """Since item 12e the pod axis builds, beside a model axis too, with
    the reference's rank order, rank = ((p * pipe + s) * data + w) * model
    + t, and the DP group over pod x data, pod-major; no mesh has pipe
    size 1. A pipe axis beside a model axis builds the (pipe, data, model)
    mesh: rank = (s * data + w) * model + t. Checked on a fake process
    group of 8 ranks from rank 5's side."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import (dp_group, dp_index, make_host_mesh,
                                         pipe_size)
    assert pipe_size(None) == 1
    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
    try:
        ranks = lambda g: dist.get_process_group_ranks(g)
        mesh = make_host_mesh(pod=2, data=4, device_type="cpu")
        assert mesh.mesh_dim_names == ("pod", "data")
        assert ranks(dp_group(mesh)) == list(range(8)) and dp_index(mesh) == 5
        mesh = make_host_mesh(pod=2, pipe=2, data=1, model=2,
                              device_type="cpu")
        assert mesh.mesh_dim_names == ("pod", "pipe", "data", "model")
        assert [mesh.get_local_rank(n) for n in mesh.mesh_dim_names] == \
            [1, 0, 0, 1]
        assert ranks(dp_group(mesh)) == [1, 5] and dp_index(mesh) == 1
        assert ranks(mesh.get_group("pipe")) == [5, 7]
        mesh = make_host_mesh(pipe=2, model=4, device_type="cpu")
        assert mesh.mesh_dim_names == ("pipe", "data", "model")
        assert mesh.mesh.tolist() == [[[0, 1, 2, 3]], [[4, 5, 6, 7]]]
        assert [mesh.get_local_rank(n) for n in mesh.mesh_dim_names] == [1, 0, 1]
        group = lambda n: ranks(mesh.get_group(n))
        assert group("model") == [4, 5, 6, 7]
        assert group("pipe") == [1, 5] and group("data") == [5]
        assert pipe_size(mesh) == 2
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(script, n, out, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               str(port), str(out),
                               os.path.join(ROOT, "tests")],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


def test_overlapped_1f1b_parity_gloo_mesh(tmp_path):
    """Four gloo processes: the overlapped trainer on a (pipe=2, data=2)
    mesh against a flat data=2 run. The plan is feasible with in-loop
    launches, the DAC holds the planner's slack, and each stage's chunk
    bytes plus its shared leaves equal ``stage_wire_bytes``."""
    out = tmp_path / "mesh"
    _spawn(_MESH, 4, out)
    res = [json.loads((tmp_path / f"mesh.{r}").read_text()) for r in range(4)]
    # rank = s * W + w: pipe outer, each stage a contiguous DP group
    assert [(r["stage"], r["dp_rank"], r["world"]) for r in res] == [
        (0, 0, 2), (0, 1, 2), (1, 0, 2), (1, 1, 2)]
    for r in res:
        gap = max(abs(a - b) for a, b in zip(r["lo"], r["lf"], strict=True))
        assert gap < 5e-3, (r["lo"], r["lf"])
        assert r["lo"] == res[0]["lo"]
        assert all(r["feasible"]) and r["in_loop"] > 0
        assert r["slack"] is not None
        assert r["ranks_ok"]
        assert [m + sh for m, sh in zip(r["moved"], r["shared"])] == \
            r["ledger"]


# ------------------------------ a DistPipe trainer's checkpoints
_CKPT = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    from test_torch_overlap import _ckpt_run
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    res = _ckpt_run(out)
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
""")


def _ckpt_run(out):
    """Two gloo processes, one stage each (a (pipe=2, data=1) mesh): six
    overlapped steps saved at step 3, then a fresh trainer restored from
    it runs steps 3-5."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(pipe=2, data=1, device_type="cpu")
    full = _mesh_trainer(mesh, overlap=True, ckpt_every=3, ckpt_path=out)
    hist = full.run(SyntheticLM(**DATA).batches())
    resumed = _mesh_trainer(mesh, overlap=True)
    step = resumed.restore_checkpoint(out + "_3")
    data = SyntheticLM(**DATA).batches()
    for _ in range(3):
        next(data)
    rest = resumed.run(data)
    return {"step": step, "full": hist[3:], "rest": rest,
            "equal": all(torch.equal(a, b) for a, b in
                         zip(tree.leaves(resumed.state),
                             tree.leaves(full.state), strict=True)),
            "stage_shape": list(full.state["stage_params"]["blocks"]["attn"]
                                ["wq"].shape)}


def test_distpipe_trainer_checkpoint_save_restore_resume(tmp_path):
    """A trainer that hosts one stage per gloo process saves the reference's
    layout (every stage, (S, W, ...) compressor leaves) from its slices,
    and a run restored from it continues exactly as the unbroken one; the
    archive restores into a LocalPipe trainer too."""
    out = tmp_path / "run"
    _spawn(_CKPT, 2, out)
    res = [json.loads((tmp_path / f"run.{r}").read_text()) for r in range(2)]
    for r in res:
        assert r["step"] == 3 and r["equal"]
        assert r["stage_shape"][0] == 1          # the hosted stage's slice
        for a, b in zip(r["rest"], r["full"], strict=True):
            assert a["step"] == b["step"]
            assert abs(a["loss"] - b["loss"]) < 1e-6, (a, b)
            assert a["bytes_synced"] == b["bytes_synced"]
    names = json.loads(open(str(out) + "_3.json").read())["names"]
    with np.load(str(out) + "_3.npz") as z:
        comp = [i for i, n in enumerate(names) if n.startswith("['comp']")]
        assert comp and all(z[f"leaf_{i}"].shape[:2] == (2, 1) for i in comp)
        stage = [i for i, n in enumerate(names)
                 if n.startswith("['stage_params']")]
        assert stage and all(z[f"leaf_{i}"].shape[:2] == (2, 2)
                             for i in stage)
    # the same archive restores into one process hosting both stages, whose
    # next step equals the mesh run's
    local = _mesh_trainer(None, overlap=True)
    assert local.restore_checkpoint(str(out) + "_3") == 3
    data = SyntheticLM(**DATA).batches()
    for _ in range(3):
        next(data)
    hist = local.run(data, num_steps=1)
    assert abs(hist[0]["loss"] - res[0]["full"][0]["loss"]) < 1e-6


# ------------------------- the overlapped trainer against the reference's
_REF_OVERLAP = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import AxisType, Mesh
    from repro.core import EDGCConfig, GDSConfig
    from repro.core.dac import DACConfig
    from repro.data.pipeline import SyntheticLM
    from repro.models.model import ModelConfig, build_model
    from repro.obs import MemorySink, MetricsRegistry
    from repro.optim.adam import AdamConfig
    from repro.train.trainer import Trainer, TrainerConfig

    out = sys.argv[1]
    steps = 4
    devs = np.array(jax.devices()[:4]).reshape(4, 1, 1)
    mesh = Mesh(devs, ("pipe", "data", "model"),
                axis_types=(AxisType.Auto,) * 3)
    cfg = ModelConfig(name="pp", family="dense", num_layers=4, d_model=128,
                      num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
                      num_stages=4)
    edgc = EDGCConfig(policy="fixed", fixed_rank=8, num_stages=4,
                      total_iterations=steps,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=3, adjust_limit=4))
    sink = MemorySink()
    tcfg = TrainerConfig(total_steps=steps, log_every=1, schedule="1f1b",
                         num_microbatches=4, overlap_sync=True,
                         chunk_bytes=1 << 14, metrics=MetricsRegistry([sink]),
                         adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=steps))
    tr = Trainer(build_model(cfg), mesh, edgc, tcfg, seed=0)
    tr.save_checkpoint(out + "/start", step=0)
    hist = tr.run(SyntheticLM(512, 32, 8, seed=3).batches())
    np.savez(out + "/ref.npz",
             loss=np.array([h["loss"] for h in hist]),
             entropy=np.array([h["entropy"] for h in hist]),
             bytes_synced=np.array([h["bytes_synced"] for h in hist]),
             stage_bytes=np.array([h["stage_bytes"] for h in hist]))
    with open(out + "/events.json", "w") as f:
        json.dump([e for e in sink.events()
                   if e["name"] in ("overlap_plan", "run_meta")], f)
    print("REF_OVERLAP_OK")
""")


def test_overlapped_trainer_s4_equals_reference_subprocess(tmp_path):
    """S = 4, M = 4, 1F1B, fixed rank 8, chunks of 16 KiB: the reference's
    overlapped trainer on four fake devices in a subprocess; the port
    restores its starting checkpoint and runs the same four steps with its
    four stage programs in this process. The ``overlap_plan`` event and the
    report's overlap line are the reference's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF_OVERLAP, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "REF_OVERLAP_OK" in proc.stdout, \
        proc.stdout[-3000:] + proc.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    ref_events = json.loads((tmp_path / "events.json").read_text())
    sink = MemorySink()
    cfg = ModelConfig(**dict(TINY, name="pp", num_layers=4, num_stages=4))
    port = Trainer(
        build_model(cfg),
        EDGCConfig(policy="fixed", fixed_rank=8, num_stages=4,
                   total_iterations=4, gds=GDSConfig(alpha=0.5, beta=0.25),
                   dac=DACConfig(window=3, adjust_limit=4)),
        TrainerConfig(total_steps=4, log_every=1, schedule="1f1b",
                      num_microbatches=4, overlap_sync=True,
                      chunk_bytes=1 << 14, metrics=MetricsRegistry([sink]),
                      adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                      total_steps=4)),
        seed=0, device="cpu", pipe=4)
    assert port.restore_checkpoint(str(tmp_path / "start")) == 0
    hist = port.run(SyntheticLM(**DATA).batches())
    assert len(hist) == 4
    for h, loss, ent, b, sb in zip(hist, ref["loss"], ref["entropy"],
                                   ref["bytes_synced"], ref["stage_bytes"]):
        assert abs(h["loss"] - loss) < 5e-3, (h, loss)
        assert abs(h["entropy"] - ent) < 1e-4, (h, ent)
        assert h["bytes_synced"] == b
        assert [list(x) for x in h["stage_bytes"]] == sb.tolist()
    got = [e for e in sink.events() if e["name"] == "overlap_plan"]
    want = [e for e in ref_events if e["name"] == "overlap_plan"]
    assert [e["data"] for e in got] == [e["data"] for e in want]
    assert got[0]["data"]["in_loop"] == [0, 1, 2, 3]
    # the report's overlap line reads keys the trainer does not write, in
    # both packages alike (a reference defect the port shares on purpose)
    line = lambda lines: [x for x in lines if x.startswith("overlap plan:")]
    meta = [e for e in sink.events() if e["name"] in ("run_meta",
                                                      "overlap_plan")]
    assert line(build_report(meta)) == line(ref_build_report(ref_events)) \
        == ["overlap plan: in-loop None residual None chunks, slack util "
            "0.30, feasible=[True, True, True, True]"]
