"""The port's collective-safety auditor (``repro_torch.analysis``,
``repro_torch.launch.audit``) against the reference's (``repro.analysis``,
``repro/launch/audit.py``).

(a) the reference's unit tests (``tests/test_analysis.py``), case for case,
on recorded rank logs instead of traced jaxprs; (b) the lint and the
step-cache check against the reference's; (c) the psum budgets against the
reference's: the spy on the same plan, and the overlapped step's launches
against the reference's switch branches; (d) seeded mutations: a dropped
factor psum, a rank that skips a chunk, a host read in a step; (e) the
entropy gates; (f) the CLI on the CPU.

A fake default process group is process-global, and the reference's
pipelined trace needs several fake XLA devices: those parts run in
subprocesses (``tests/_torch_audit_jobs.py`` and the CLI), all started
together when the first test that reads one asks for them."""
import base64
import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import analysis
from repro_torch.analysis import CollectiveCall, RankLog
from repro_torch.analysis.lint import lint_source

ROOT = pathlib.Path(__file__).resolve().parents[1]
AR = lambda group=(0, 1), label=None: CollectiveCall(
    "all-reduce", group, (((4,), "float32"),), (("op", "sum"),),
    label=label)


def _ref_audit():
    """``repro.launch.audit`` without its XLA_FLAGS (set at import)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.audit as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


# ------------------------------------------------------------ subprocesses
JOBS = {"port": ["port_units", "port_overlap"], "ref": ["ref_overlap"]}
CLI = {
    "builtins": ["--device", "cpu"],
    "zoo": ["--device", "cpu", "--skip-lint", "--arch", "qwen2-0.5b",
            "--shape", "train_4k", "--pipe", "2", "--overlap"],
    "no_card": ["--skip-lint", "--skip-train"],
}


class _Runs:
    """Every subprocess of the module, started at once; ``get`` waits for
    one and returns (exit code, stdout, stderr)."""

    def __init__(self, tmp):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
        env.pop("CUDA_VISIBLE_DEVICES", None)
        py = sys.executable
        self.report = tmp / "audit.json"
        self.procs = {
            name: subprocess.Popen(
                [py, str(ROOT / "tests" / "_torch_audit_jobs.py"), *jobs],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            for name, jobs in JOBS.items()}
        out = {"builtins": ["--out", str(self.report)]}
        self.procs.update({
            name: subprocess.Popen(
                [py, "-m", "repro_torch.launch.audit", *args,
                 *out.get(name, [])], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name, args in CLI.items()})
        self.done = {}

    def get(self, name):
        if name not in self.done:
            out, err = self.procs[name].communicate(timeout=600)
            self.done[name] = (self.procs[name].returncode, out, err)
        return self.done[name]

    def job(self, side, job):
        rc, out, err = self.get(side)
        assert rc == 0, err[-3000:]
        blob = json.loads(out.strip().splitlines()[-1])[job]
        return pickle.loads(base64.b64decode(blob))

    def close(self):
        for p in self.procs.values():
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory.mktemp("audit"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def units(runs):
    return runs.job("port", "port_units")


@pytest.fixture(scope="module")
def overlap(runs):
    return runs.job("port", "port_overlap")


# ------------------------------------------------------- (a) dispatch_log
def test_walk_paths_and_signature_order(units):
    log = units["signature"][0]
    sig = analysis.collective_signature(log)
    assert [c.kind for c in sig] == ["all-reduce"] * 5
    assert [dict(c.params)["op"] for c in sig] == ["sum", "max", "max",
                                                   "max", "sum"]
    assert all(c.group == (0, 1) for c in sig)
    # the port's calls are path-qualified into the port's source, and the
    # loop's under the launch label it ran in
    assert sig[0].path.startswith("repro_torch/dist/collectives.py:")
    assert [c.label for c in sig] == [None, (5, 0), (5, 0), (5, 0), None]
    assert analysis.collective_signature(log, group=(0, 2)) == ()


def test_count_collectives_counts_calls_not_strings(units):
    log = units["lookalike"][0]         # a variable NAME must not count
    assert analysis.count_collectives(log, "all-reduce") == 1
    assert analysis.count_collectives(log) == 1


# ----------------------------------------------------------- (a) parity
def test_parity_identical_branches_pass(units):
    assert analysis.check_collective_parity(units["identical"]) == []


def test_parity_divergent_data_predicate_flagged(units):
    """A rank-dependent predicate with a collective in one branch is the
    canonical deadlock; the diagnostic names the group and the first
    divergence."""
    (v,) = analysis.check_collective_parity(units["divergent"])
    assert v.rule == "collective-parity"
    assert v.path == "group=[0, 1]"
    assert "all-reduce[0,1]" in v.message and "rank 0 issues 1 extra" \
        in v.message


def test_parity_stage_predicate_is_safe(units):
    """The overlapped executor's shape: each stage launches its own
    collectives over its own data group. Every data-group peer is in the
    same stage, so the stages may differ: must pass."""
    assert analysis.check_collective_parity(units["by_stage"]) == []


def test_parity_collective_over_predicate_axis_flagged(units):
    """Same stage predicate, but a PIPE-group collective in one stage only:
    the pipe peers disagree, a deadlock."""
    (v,) = analysis.check_collective_parity(units["over_pipe"])
    assert v.rule == "collective-parity" and v.path == "group=[0, 2]"


def test_parity_reduced_value_predicate_is_safe(units):
    """A predicate on a value reduced over 'data' is equal on every data
    rank: the collectives behind it cannot diverge."""
    assert analysis.check_collective_parity(units["reduced"]) == []


def test_parity_names_divergence_inside_a_launch(units):
    """A divergence inside a labelled launch (the executor's counterpart of
    a switch in a scan body) is reported with its tick and stage."""
    (v,) = analysis.check_collective_parity(units["in_launch"])
    assert "(tick 5, stage 0)" in v.message and v.path == "group=[0, 1]"


def test_parity_pairs_sends_with_receives(units):
    (v,) = analysis.check_collective_parity(units["p2p"])
    assert v.path == "p2p 0->2" and "float32[5]" in v.message


# ---------------------------------------------------- (a) launch budgets
def test_launch_budgets_clean_and_dropped_psum_caught(units):
    log = units["budgets"][0]
    assert analysis.launch_collective_counts(log) == (((4, 0), 1),
                                                       ((4, 1), 2))
    assert analysis.check_launch_budgets(log, {(4, 0): 1, (4, 1): 2}) == []
    # the seeded-mutation shape: stage 1 declared 3 all-reduces, ran 2
    (v,) = analysis.check_launch_budgets(log, {(4, 0): 1, (4, 1): 3})
    assert v.rule == "psum-budget" and v.path == "tick=4/stage=1"
    assert "launch issues 2" in v.message and "expects 3" in v.message


def test_launch_budgets_launch_count_mismatch(units):
    log = units["budgets"][0]
    (v,) = analysis.check_launch_budgets(
        log, [((4, 0), 1), ((4, 1), 2), ((9, 0), 7)])
    assert v.rule == "psum-budget" and "no launch ran" in v.message
    (v,) = analysis.check_launch_budgets(log, {(4, 0): 1})
    assert v.path == "tick=4/stage=1" and "does not have" in v.message


# ------------------------------------------------------ (a) CollectiveSpy
def test_collective_spy_against_real_layout():
    from repro_torch.core.bucketing import make_bucket_layout
    from repro_torch.core.compressor import (classify_leaves,
                                             init_compressor_state,
                                             make_plan, sync_grads)

    rng = np.random.default_rng(0)
    params = {k: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
              for k, s in (("a", (64, 96)), ("b", (64, 96)), ("small", (8,)))}
    leaves = classify_leaves(params, num_layers=1, num_stages=1, min_dim=32)
    plan = make_plan("fixed", leaves, fixed_rank=4)
    layout = make_bucket_layout(leaves, plan)
    state = init_compressor_state(params, plan, 0, layout=layout)
    spy = analysis.CollectiveSpy()
    sync_grads(params, state, plan, spy, bucketed=True)
    assert analysis.check_sync_spy(spy, layout) == []
    assert spy.factor_ranks() == [4]

    # a spy that saw one launch too few fails the budget with a reason
    short = analysis.CollectiveSpy()
    short.calls = spy.calls[:-1]
    bad = analysis.check_sync_spy(short, layout)
    assert bad and all(v.rule == "psum-budget" for v in bad)


def test_entropy_gate_negative():
    two, one = RankLog(calls=[AR(), AR()]), RankLog(calls=[AR()])
    assert analysis.check_entropy_gate(two, one, expected_delta=1) == []
    (v,) = analysis.check_entropy_gate(two, one, expected_delta=3)
    assert v.rule == "entropy-gate" and "delta 1" in v.message


# --------------------------------------------------------- (a) hostcalls
def test_host_transfer_flagged_and_clean():
    x = torch.ones(3)

    def dirty():
        (x * 2).sum().item()

    def clean():
        return x * 2

    logs = {}
    for name, fn in (("dirty", dirty), ("clean", clean)):
        logs[name] = analysis.CollectiveLog()
        with logs[name]:
            fn()
    (v,) = analysis.check_host_transfers(logs["dirty"])
    assert v.rule == "host-sync" and "round-trip" in v.message
    assert "aten._local_scalar_dense" in v.message
    assert analysis.check_host_transfers(logs["clean"]) == []
    # an explicit allowlist admits intentional syncs
    (sync,) = logs["dirty"].host_syncs
    assert sync.op == "aten._local_scalar_dense"
    assert analysis.check_host_transfers(logs["dirty"],
                                         allow=[sync.op]) == []


def test_step_cache_window_bounds():
    keys = [(f"plan{i}", m, "sync") for i in range(2) for m in (True, False)]
    assert analysis.check_step_cache(keys, steps=6, window=3) == []
    # 4 distinct plans after 6 steps with window=3 exceeds the bound of 3
    keys = [(f"plan{i}", True, "sync") for i in range(4)]
    (v,) = analysis.check_step_cache(keys, steps=6, window=3)
    assert v.rule == "recompile" and "window boundaries" in v.message
    # unhashable keys are flagged before any counting
    (v,) = analysis.check_step_cache([(["unhashable"], True, "s")],
                                     steps=1, window=1)
    assert v.rule == "recompile" and "unhashable" in v.message


# -------------------------------------------------------------- (a) lint
def test_lint_dup_dict_key():
    (f,) = lint_source('D = {"s64": 8, "u64": 8, "s64": 8}')
    assert f.rule == "dup-dict-key" and "'s64'" in f.message
    assert lint_source('D = {"s64": 8, "u64": 8}') == []
    # non-constant keys never crash or false-positive
    assert lint_source("D = {k: 1, k: 2}") == []


def test_lint_op_cost_tables_regression():
    """The tables the audit shares with the cost counter (``op_cost``'s
    collectives) carry no duplicate entry."""
    from repro_torch.analysis.dispatch_log import COLLECTIVE_OPS
    from repro_torch.launch.op_cost import (C10D_COLLECTIVES,
                                            FUNCTIONAL_COLLECTIVES)
    path = ROOT / "src" / "repro_torch" / "launch" / "op_cost.py"
    assert [f for f in lint_source(path.read_text(), str(path))
            if f.rule == "dup-dict-key"] == []
    assert (len(C10D_COLLECTIVES), len(FUNCTIONAL_COLLECTIVES)) == (13, 12)
    # the point-to-point receive is split from op_cost's permute kind; send,
    # recv_any_source_ and barrier are the audit's own
    assert len(COLLECTIVE_OPS) == 13 + 2 * 12 + 3
    assert COLLECTIVE_OPS[("c10d", "recv_")] == "recv"


def test_lint_host_call_in_hot_path():
    hot = "src/repro_torch/core/powersgd.py"
    for src in ("x = float(y)", "n = int(t)", "b = bool(t)", "v = t.item()",
                "v = t.tolist()", "v = t.cpu()", "v = t.numpy()",
                "torch.cuda.synchronize()",
                "import numpy as np\nz = np.sum(y)"):
        assert lint_source(src, hot)[0].rule == "host-call-in-hot-path", src
    # a literal is not a tensor
    assert lint_source('x = float("nan")', hot) == []
    # the port adds the pipelined executor and the model axis
    for path in ("src/repro_torch/pipeline/executor.py",
                 "src/repro_torch/dist/tp.py"):
        assert lint_source("v = t.item()", path)
    # same source outside the hot-path list is fine
    assert lint_source("x = float(y)",
                       "src/repro_torch/train/trainer.py") == []
    # the inline allowlist suppresses with a reason
    allowed = "x = float(y)  # lint: allow(host-call-in-hot-path) static"
    assert lint_source(allowed, hot) == []


def test_lint_collective_group():
    src = ("import torch.distributed as dist\ndist.all_reduce(x)\n"
           "dist.all_reduce(x, group=g)\ndist.barrier(group=g)\n"
           "torch.distributed.broadcast(x, 0)\n")
    found = lint_source(src)
    assert [(f.rule, f.line) for f in found] == [("collective-group", 2),
                                                 ("collective-group", 5)]


def test_lint_unhashable_cache_key():
    (f,) = lint_source("self._step_cache[[p, m]] = step")
    assert f.rule == "unhashable-cache-key"
    assert lint_source("self._step_cache[(p, m)] = step") == []
    assert lint_source("values[[1, 2]] = x") == []    # not a cache name


def test_lint_repo_clean():
    """The blocking-gate invariant: the port's tree lints clean."""
    roots = [str(ROOT / r) for r in analysis.LINT_ROOTS]
    assert analysis.lint.iter_py_files(roots)
    assert [str(f) for f in analysis.run_lint(roots)] == []


# ------------------------------------- (a) the overlapped step, rank by rank
def test_overlapped_step_audit_and_seeded_mutation(overlap):
    logs = overlap["overlap"]
    oplan, splans = overlap["oplan"], overlap["splans"]
    # clean step: parity, declared budgets, host-sync all pass
    assert analysis.check_collective_parity(logs) == []
    assert analysis.check_overlap_branches(logs, oplan, splans) == []
    assert all(analysis.check_host_transfers(l) == [] for l in logs.values())
    # every stage's data group, pipe group and pipe messages were seen
    groups = {c.group for l in logs.values() for c in l.calls}
    assert groups == {(0, 1), (2, 3), (0, 2), (1, 3)}
    assert {c.kind for c in logs[0].calls} == {"all-reduce", "send", "recv"}

    # SEEDED MUTATION: the second factor psum of every group chunk dropped
    found = analysis.check_overlap_branches(overlap["dropped"], oplan, splans)
    assert found, "seeded dropped-psum mutation not caught"
    assert all(v.rule == "psum-budget" for v in found)
    assert all("tick=" in v.path and "/stage=" in v.path for v in found), \
        [str(v) for v in found]


# -------------------------------------------- (b) lint against the reference
LINT_SAMPLES = [
    'D = {"s64": 8, "u64": 8, "s64": 8}',
    'D = {1: "a", 2: "b", 1: "c", True: 0}',
    "D = {k: 1, k: 2}\nE = {'x': {'y': 1, 'y': 2}}",
    "self._step_cache[[p, m]] = step",
    "self._step_cache[(p, m)] = step\ncache[{1, 2}]\ncache[[x for x in y]]",
    "values[[1, 2]] = x",
    "def f(:\n    pass",
]
SHARED_RULES = ("dup-dict-key", "unhashable-cache-key")


def _shared(findings):
    return sorted((f.file, f.line, f.rule) for f in findings
                  if f.rule in SHARED_RULES)


@pytest.mark.parametrize("src", LINT_SAMPLES, ids=range(len(LINT_SAMPLES)))
def test_lint_matches_reference_on_samples(src):
    from repro.analysis.lint import lint_source as ref_lint_source
    assert _shared(lint_source(src, "s.py")) == \
        _shared(ref_lint_source(src, "s.py"))


def test_lint_matches_reference_on_every_reference_file():
    from repro.analysis.lint import iter_py_files
    from repro.analysis.lint import lint_source as ref_lint_source
    files = iter_py_files([str(ROOT / "src" / "repro")])
    assert len(files) > 50
    for path in files:
        src = pathlib.Path(path).read_text()
        assert _shared(lint_source(src, path)) == \
            _shared(ref_lint_source(src, path)), path


@pytest.mark.parametrize("case", [
    dict(keys=[(f"p{i}", m, "s") for i in range(2) for m in (True, False)],
         steps=6, window=3),
    dict(keys=[(f"p{i}", True, "s") for i in range(4)], steps=6, window=3),
    dict(keys=[(f"p{i}", True, f"c{i}") for i in range(3)], steps=4,
         window=2),
    dict(keys=[(["x"], True, "s")], steps=1, window=1),
    dict(keys=[], steps=0, window=5),
], ids=["bounded", "plans", "codecs", "unhashable", "empty"])
def test_step_cache_matches_reference(case):
    from repro.analysis.hostcalls import check_step_cache as ref_check
    got = analysis.check_step_cache(**case)
    want = ref_check(**case)
    assert [(v.rule, v.path, v.message) for v in got] == \
        [(v.rule, v.path, v.message) for v in want]


# ----------------------------------------- (c) budgets against the reference
def test_family_configs_equal_the_reference():
    from repro_torch.launch.audit import FAMILY_CFGS
    ref = _ref_audit().FAMILY_CFGS
    assert list(FAMILY_CFGS) == list(ref)
    for fam, cfg in FAMILY_CFGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref[fam]), fam


def test_spy_matches_reference_on_the_dense_plan():
    """The bucketed sync of ``FAMILY_CFGS["dense"]``'s flat edgc plan (rank
    8) in both packages, through each one's ``spy_sync``: the same count,
    factor/flat split and ranks, the layout's bill."""
    import jax
    from repro.analysis import spy_sync as ref_spy_sync
    from repro.core import classify_leaves as ref_classify
    from repro.core import init_compressor_state as ref_init
    from repro.core import make_bucket_layout as ref_layout
    from repro.core import make_plan as ref_make_plan
    from repro.core import sync_grads as ref_sync
    from repro.models.model import build_model as ref_build
    from repro_torch.core.bucketing import make_bucket_layout
    from repro_torch.core.compressor import (classify_leaves,
                                             init_compressor_state,
                                             make_plan, sync_grads)
    from repro_torch.launch.audit import FAMILY_CFGS
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(FAMILY_CFGS["dense"], num_stages=1)
    ref_cfg = dataclasses.replace(_ref_audit().FAMILY_CFGS["dense"],
                                  num_stages=1)
    model = ref_build(ref_cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    leaves = ref_classify(params, cfg.num_layers, 1, min_dim=64)
    plan = ref_make_plan("edgc", leaves, stage_ranks=[8], num_stages=1)
    layout = ref_layout(leaves, plan)
    state = jax.eval_shape(lambda p: ref_init(p, plan, jax.random.PRNGKey(1),
                                              layout=layout), params)
    want = ref_spy_sync(lambda g, st, spy: ref_sync(g, st, plan, spy,
                                                    bucketed=True),
                        params, state)

    p = build_model(cfg).init(0, "cpu")
    pleaves = classify_leaves(p, cfg.num_layers, 1, min_dim=64)
    pplan = make_plan("edgc", pleaves, stage_ranks=[8], num_stages=1)
    playout = make_bucket_layout(pleaves, pplan)
    pstate = init_compressor_state(p, pplan, 1, layout=playout)
    got = analysis.spy_sync(lambda g, st, spy: sync_grads(g, st, pplan, spy,
                                                          bucketed=True),
                            p, pstate)
    summary = lambda s: (len(s), len(s.factor_calls), len(s.flat_calls),
                         s.factor_ranks(), sorted(sh for sh, _ in s.calls))
    assert summary(got) == summary(want)
    assert len(got) == playout.num_collectives() == layout.num_collectives()
    assert analysis.check_sync_spy(got, playout) == []


def test_launch_counts_match_reference_switches(runs, overlap):
    """The port's per-launch all-reduces of the overlapped dense step at
    (pipe 2, data 2), stage by stage, equal the reference's per-branch
    psums of its launch switches (in-loop ticks in order, then the
    residual), and both equal the declared schedule."""
    ref = runs.job("ref", "ref_overlap")
    assert ref["parity"] == []
    counts = {}
    for r, log in overlap["overlap"].items():
        if r % 2 == 0:                  # one data rank a stage
            counts.update(analysis.launch_collective_counts(log))
    in_loop, residual = ref["declared"]
    ticks = [t for t, _ in in_loop]
    got = [tuple(counts.get((t, s), 0) for s in range(2)) for t in ticks]
    got.append(tuple(counts.get((-1, s), 0) for s in range(2)))
    assert got == [tuple(c) for c in ref["switches"]]
    assert got == [tuple(c) for _, c in in_loop] + [tuple(residual)]


# -------------------------------------------------- (d) seeded mutations
def test_rank_that_skips_a_chunk_is_caught(overlap):
    found = analysis.check_collective_parity(overlap["skipping"])
    (v,) = found
    assert v.rule == "collective-parity" and v.path == "group=[0, 1]"
    assert "ranks 0 and 1" in v.message
    assert "first divergence at collective #" in v.message or \
        "extra collective" in v.message
    # the clean run's ranks agree
    assert analysis.check_collective_parity(overlap["overlap"]) == []


def test_host_read_inside_a_step_is_caught(overlap):
    (v,) = analysis.check_host_transfers(overlap["item"])
    assert v.rule == "host-sync"
    assert v.path.startswith("repro_torch/train/step.py:")
    assert "aten._local_scalar_dense" in v.message
    assert analysis.check_host_transfers(overlap["flat"][0]) == []


# ------------------------------------------------------ (e) entropy gates
def test_entropy_gates_in_both_packages(runs, overlap):
    ref = runs.job("ref", "ref_overlap")
    ref_pipe_on, ref_pipe_off = ref["pipelined_psums"]
    ref_flat_on, ref_flat_off = ref["flat_psums"]
    assert ref_pipe_on - ref_pipe_off == 3 and ref_flat_on == ref_flat_off
    # the port stacks the three moments into one (3, S) pipe all-reduce
    assert analysis.ENTROPY_PSUMS == 1
    assert analysis.check_entropy_gate(
        overlap["overlap"][0], overlap["overlap_off0"],
        analysis.ENTROPY_PSUMS, where="dense:pipelined") == []
    assert analysis.check_entropy_gate(
        overlap["flat"][0], overlap["flat_off0"], 0,
        where="dense:flat") == []
    # the gate is not vacuous: the wrong count is caught
    assert analysis.check_entropy_gate(
        overlap["overlap"][0], overlap["overlap_off0"], 3)


# ------------------------------------------------------------- (f) the CLI
def test_audit_cli_runs_every_builtin_target_clean(runs):
    rc, out, err = runs.get("builtins")
    assert rc == 0, out[-3000:] + err[-3000:]
    lines = out.strip().splitlines()
    assert lines[0] == "collective-safety audit"
    assert lines[-1] == "27 target(s), 0 violation(s)"
    report = json.loads(runs.report.read_text())
    names = [t["target"] for t in report["targets"]]
    assert report["violations"] == []
    for fam in ("dense", "moe", "xlstm", "zamba", "whisper", "vlm",
                "dense+quant8"):
        for check in ("parity", "psum-budget", "host-sync"):
            assert f"{fam}:pipelined-overlapped:{check}" in names
    for name in ("dense:flat:parity", "dense:flat:host-sync",
                 "dense:pipelined:entropy-gate", "dense:flat:entropy-gate",
                 "trainer:recompile-window"):
        assert name in names
    assert names[0].startswith("lint:src/repro_torch")


def test_audit_cli_zoo_config(runs):
    rc, out, err = runs.get("zoo")
    assert rc == 0, out[-3000:] + err[-3000:]
    assert out.strip().splitlines()[-1] == "3 target(s), 0 violation(s)"
    for check in ("parity", "host-sync", "psum-budget"):
        assert f"zoo:qwen2-0.5b:train_4k:{check}" in out


def test_audit_cli_refuses_cuda_without_a_card(runs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    rc, out, err = runs.get("no_card")
    assert rc != 0 and "--device cpu" in err
    assert "violation" not in out
