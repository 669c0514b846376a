"""The port's pipeline analytics and tick tracer against the reference's.

Every function of ``repro_torch.pipeline.schedule`` is pure Python, as its
reference is, so the two must agree exactly (no tolerance): the tick
tables, ring sizes, in-flight peaks, slack, stash ledgers, the event
simulation at unit and at measured tick costs, and the overlap planner on
the same stage plans. The tracer's events must serialize to the same JSON.
"""
import dataclasses
import json
from types import SimpleNamespace

import jax
import pytest

from repro.core import compressor as ref_comp
from repro.core import wire as ref_wire
from repro.models.model import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro.obs import trace as ref_trace
from repro.pipeline import partition as ref_part
from repro.pipeline import schedule as ref_sched
from repro.pipeline import sync as ref_psync

from repro_torch.core import compressor as comp
from repro_torch.core import wire
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.obs import trace
from repro_torch.pipeline import partition as part_mod
from repro_torch.pipeline import schedule as sched
from repro_torch.pipeline import sync as psync

GRID = [(1, 1), (1, 2), (2, 2), (4, 4), (4, 8), (3, 7)]
CASES = [(name, S, M) for name in sched.SCHEDULES for S, M in GRID]
MODEL = dict(name="pp", family="dense", num_layers=4, d_model=128,
             num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)


@pytest.mark.parametrize("name,S,M", CASES)
def test_tick_tables_and_analytics_equal_reference(name, S, M):
    assert sched.tick_count(name, S, M) == ref_sched.tick_count(name, S, M)
    assert sched.ring_slots(name, S, M) == ref_sched.ring_slots(name, S, M)
    assert sched.first_bwd_tick(name, S, M) == \
        ref_sched.first_bwd_tick(name, S, M)
    assert sched.slot_table(name, S, M) == ref_sched.slot_table(name, S, M)
    assert sched.bubble_fraction(S, M) == ref_sched.bubble_fraction(S, M)
    for fn in ("peak_inflight", "sync_slack_ticks", "last_backward_tick",
               "sync_ticks"):
        assert getattr(sched, fn)(name, S, M) == \
            getattr(ref_sched, fn)(name, S, M), fn
    for t in range(sched.tick_count(name, S, M)):
        for s in range(S):
            assert sched._fwd_mb(t, s) == ref_sched._fwd_mb(t, s)
            assert sched._bwd_mb(name, t, s, S, M) == \
                ref_sched._bwd_mb(name, t, s, S, M)
    for t_f, t_b in ((1.0, 1.0), (1.0, 2.5), (0.7, 1.9)):
        assert sched.tick_spans(name, S, M, t_f, t_b) == \
            ref_sched.tick_spans(name, S, M, t_f, t_b)
        assert sched.simulate_schedule(name, S, M, t_f, t_b) == \
            ref_sched.simulate_schedule(name, S, M, t_f, t_b)


@pytest.mark.parametrize("name,S,M", CASES)
@pytest.mark.parametrize("policy", sched.STASH_POLICIES)
def test_stash_ledgers_equal_reference(name, S, M, policy):
    for n_units in (1, 2, 5):
        for k in (1, 2, 3):
            assert sched.stash_points(policy, n_units, k) == \
                ref_sched.stash_points(policy, n_units, k)
            assert sched.stash_segments(policy, n_units, k) == \
                ref_sched.stash_segments(policy, n_units, k)
            assert sched.peak_activation_bytes(
                name, S, M, policy, boundary_bytes=4096, n_units=n_units,
                stash_every=k) == ref_sched.peak_activation_bytes(
                    name, S, M, policy, boundary_bytes=4096,
                    n_units=n_units, stash_every=k)
    for remat in (False, True):
        assert sched.policy_tick_cost(1.0, 2.0, policy, remat) == \
            ref_sched.policy_tick_cost(1.0, 2.0, policy, remat)


def test_unknown_names_refused_as_the_reference():
    with pytest.raises(ValueError, match="unknown schedule"):
        sched.tick_count("zigzag", 2, 2)
    with pytest.raises(ValueError, match="unknown stash policy"):
        sched.stash_points("some", 4)
    with pytest.raises(ValueError, match="unknown stash policy"):
        sched.policy_tick_cost(1.0, 1.0, "some")


def test_simulate_schedule_at_measured_tick_costs():
    """t_B != t_F moves the bubble and the slack off the unit model."""
    for name in sched.SCHEDULES:
        unit = sched.simulate_schedule(name, 4, 8)
        assert unit["bubble_fraction"] == pytest.approx(
            sched.bubble_fraction(4, 8))
        assert unit["slack_seconds"] == sched.sync_slack_ticks(name, 4, 8)
        slow_b = sched.simulate_schedule(name, 4, 8, t_f=1.0, t_b=2.0)
        assert slow_b == ref_sched.simulate_schedule(name, 4, 8, 1.0, 2.0)
        assert slow_b["slack_seconds"] != unit["slack_seconds"]


def _stage_plans(S, stage_ranks, bucket_bytes, chunk_bytes):
    """The same stage plans from both packages (tiny dense, S stages)."""
    cfg = dict(MODEL, num_stages=S)
    ref_model = ref_build_model(RefModelConfig(**cfg))
    shapes = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    leaves = ref_comp.classify_leaves(shapes, 4, S, min_dim=64)
    plan = ref_comp.make_plan("edgc", leaves, stage_ranks=list(stage_ranks),
                              num_stages=S)
    rp = ref_part.make_partition(ref_model, S)
    stage_shapes = jax.eval_shape(lambda p: rp.partition_params(p)[0], shapes)
    ref_sp = ref_psync.make_stage_plans(
        plan, S, ref_psync.stage_local_leaves(stage_shapes),
        bucket_bytes=bucket_bytes, chunk_bytes=chunk_bytes)

    model = build_model(ModelConfig(**cfg))
    params = model.init(0, "cpu")
    port_leaves = comp.classify_leaves(params, 4, S, min_dim=64)
    port_plan = comp.make_plan("edgc", port_leaves,
                               stage_ranks=list(stage_ranks), num_stages=S)
    assert port_plan.ranks == plan.ranks
    stage_p, _ = part_mod.make_partition(model, S).partition_params(params)
    sp = psync.make_stage_plans(
        port_plan, S, psync.stage_local_leaves(stage_p),
        bucket_bytes=bucket_bytes, chunk_bytes=chunk_bytes)
    return sp, ref_sp


def _plan_fields(p):
    return dataclasses.astuple(p)


@pytest.mark.parametrize("name", sched.SCHEDULES)
@pytest.mark.parametrize("M", [4, 8])
def test_plan_overlap_equal_reference(name, M):
    S = 4
    sp, ref_sp = _stage_plans(S, (4, 8, 8, 16), bucket_bytes=1 << 16,
                              chunk_bytes=1 << 14)
    comm = SimpleNamespace(world=8, hw=SimpleNamespace(ici_bw=4.5e10))
    for kw in ({}, {"t_f": 1.0, "t_b": 2.0}, {"comm": comm}):
        got = sched.plan_overlap(name, S, M, sp, **kw)
        want = ref_sched.plan_overlap(name, S, M, ref_sp, **kw)
        assert _plan_fields(got) == _plan_fields(want), kw
        assert sched.overlap_branch_psums(got, sp) == \
            ref_sched.overlap_branch_psums(want, ref_sp)
    got = sched.plan_overlap(name, S, M, sp, comm=comm,
                             codec=wire.resolve_codec("quant8"))
    want = ref_sched.plan_overlap(name, S, M, ref_sp, comm=comm,
                                  codec=ref_wire.resolve_codec("quant8"))
    assert _plan_fields(got) == _plan_fields(want)
    sim = sched.simulate_schedule(name, S, M, 1.0, 1.5, splans=sp)
    ref_sim = ref_sched.simulate_schedule(name, S, M, 1.0, 1.5, splans=ref_sp)
    assert _plan_fields(sim.pop("overlap")) == \
        _plan_fields(ref_sim.pop("overlap"))
    assert sim == ref_sim
    assert sched.slot_table(name, S, M, got) == \
        ref_sched.slot_table(name, S, M, want)


@pytest.mark.parametrize("name,S,M", [c for c in CASES if c[1] > 1])
@pytest.mark.parametrize("policy", sched.STASH_POLICIES)
def test_tick_trace_equal_reference(name, S, M, policy, tmp_path):
    kw = dict(t_f=0.8, t_b=1.7, stash_policy=policy, n_units=5,
              stash_every=2, time_unit_us=250.0, pid=3)
    got = trace.tick_trace_events(name, S, M, **kw)
    want = ref_trace.tick_trace_events(name, S, M, **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert trace.validate_trace({"traceEvents": got}) == \
        ref_trace.validate_trace({"traceEvents": want})
    n_sched = sum(1 for e in got if e.get("cat") in ("forward", "backward"))
    assert n_sched == trace.expected_span_count(name, S, M) == \
        ref_trace.expected_span_count(name, S, M)
    path = trace.write_chrome_trace(str(tmp_path / "t.json"), got,
                                    metadata={"S": S})
    assert trace.load_trace(path)["traceEvents"] == got


@pytest.mark.parametrize("name", sched.SCHEDULES)
def test_tick_trace_with_sync_plan_equal_reference(name):
    S, M = 4, 8
    sp, ref_sp = _stage_plans(S, (4, 8, 8, 16), bucket_bytes=1 << 16,
                              chunk_bytes=1 << 14)
    oplan = sched.plan_overlap(name, S, M, sp)
    ref_oplan = ref_sched.plan_overlap(name, S, M, ref_sp)
    got = trace.tick_trace_events(name, S, M, sync_plan=oplan)
    want = ref_trace.tick_trace_events(name, S, M, sync_plan=ref_oplan)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    n = sum(1 for e in got if e.get("cat") in trace.SCHEDULED_CATS)
    assert n == trace.expected_span_count(name, S, M, oplan) == \
        ref_trace.expected_span_count(name, S, M, ref_oplan)


def test_validate_trace_refuses_bad_objects():
    for bad in ({}, {"traceEvents": []},
                {"traceEvents": [{"ph": "X", "name": "a", "ts": 0,
                                  "dur": -1, "pid": 0, "tid": 0}]},
                {"traceEvents": [{"ph": "B", "name": "a"}]}):
        with pytest.raises(ValueError):
            trace.validate_trace(bad)
        with pytest.raises(ValueError):
            ref_trace.validate_trace(bad)


def test_boundary_nbytes_counts_one_microbatch():
    import torch
    model = build_model(ModelConfig(**dict(MODEL, num_stages=2,
                                           dtype="bfloat16")))
    part = part_mod.make_partition(model, 2)
    mb = {"tokens": torch.zeros((2, 16), dtype=torch.long)}
    assert sched.boundary_nbytes(part, mb) == 2 * 16 * 128 * 2
