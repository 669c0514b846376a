"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro/launch/dryrun.py``): the input shapes and specs, the
production mesh, the prefill and serve steps, the train FLOPs of every
family against the reference's loop-scaled HLO count, the DP all-reduce
bytes against the plan reckoned by hand, ``record_summary``, the outer
sync's wire bytes, and the CLI on ``--device cpu``.

A fake default process group is process-global, and the reference's
production mesh needs 512 fake XLA devices: those parts run in
subprocesses (``tests/_torch_dryrun_jobs.py``), all started together
when the first test that reads one asks for them."""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_INPUT_SHAPES
from repro.configs import get_config as ref_get_config
from repro.core import classify_leaves as ref_classify_leaves
from repro.core import make_plan as ref_make_plan
from repro.core.compressor import plan_wire_bytes as ref_plan_wire_bytes
from repro.models.model import build_model as ref_build_model
from repro.train import step as ref_step
from repro_torch import tree
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core.compressor import classify_leaves, make_plan
from repro_torch.launch import dryrun
from repro_torch.models.model import build_model
from repro_torch.train.step import make_prefill_step, make_serve_step

from _torch_dryrun_jobs import RANK, SPLIT_ARCHS
from _torch_families import assert_close, batches, pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH_IDS = [a for a in REF_ARCHS if a != "gpt2"]


def _ref_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:                    # the reference's import sets XLA_FLAGS
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


# ------------------------------------------------------------ subprocesses
JOBS = {
    "port": ["port_mesh", "port_flops", "port_allreduce4"],
    "ref": ["ref_mesh", "ref_flops"],
    "port_2x2": ["port_flops_2x2"],
    "ref_2x2": ["ref_flops_2x2"],
}
CLI = {
    "train": ["--shape", "train_4k"],
    "prefill": ["--shape", "prefill_32k"],
    "decode": ["--shape", "decode_32k"],
    "pipe2": ["--shape", "train_4k", "--pipe", "2"],
}


class _Runs:
    """Every subprocess of the module, started at once; ``get`` waits for
    one and returns (exit code, stdout, stderr)."""

    def __init__(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
        py = sys.executable
        self.procs = {
            name: subprocess.Popen(
                [py, str(ROOT / "tests" / "_torch_dryrun_jobs.py"), *jobs],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            for name, jobs in JOBS.items()}
        self.procs.update({
            name: subprocess.Popen(
                [py, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
                 "--arch", "qwen2-0.5b", *args], env=env,
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
        return json.loads(out.strip().splitlines()[-1])[job]

    def close(self):
        for p in self.procs.values():
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def runs():
    r = _Runs()
    yield r
    r.close()


# ------------------------------------------------------------ input shapes
def test_input_shapes_equal_the_reference():
    assert INPUT_SHAPES == REF_INPUT_SHAPES


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(REF_INPUT_SHAPES))
def test_input_specs_match_reference(arch, shape):
    """Shapes and dtypes of every batch entry, as
    ``tests/test_dryrun_specs.py`` checks the reference's."""
    variant = "long" if shape == "long_500k" else "full"
    ref_cfg, cfg = ref_get_config(arch, variant), get_config(arch, variant)
    assert (ref_cfg is None) == (cfg is None)
    if cfg is None:
        return
    want = _ref_dryrun().input_specs(ref_cfg, shape)
    got = dryrun.input_specs(cfg, shape)
    assert sorted(got) == sorted(want)
    for k, sp in want.items():
        assert got[k].shape == tuple(sp.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == np.dtype(
            sp.dtype).name, k


# ------------------------------------------------------------------- mesh
@pytest.mark.parametrize("mesh", ["single", "multi", "pipe2", "pipe4",
                                  "pipe3"])
def test_production_mesh_matches_reference(runs, mesh):
    """Shape, axis names and DP axes; the same error where ``pipe`` does
    not divide the pod."""
    assert runs.job("port", "port_mesh")[mesh] == runs.job(
        "ref", "ref_mesh")[mesh]


# ------------------------------------------------------ prefill and serve
STEP_ARCHS = ["qwen2-0.5b", "xlstm-125m"]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_prefill_step_matches_reference_forward(arch):
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        ref_get_config(arch, "reduced"))
    ref_batch, batch = batches(cfg, seq=24)
    want = jax.jit(ref_step.make_prefill_step(ref_model))(params_np,
                                                          ref_batch)
    got = make_prefill_step(model)(params, batch)
    assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_serve_step_matches_reference_decode(arch):
    """Eight tokens through both serve steps from empty caches (the
    decode tests' bars: rtol 1e-5, atol 1e-6 of the largest logit)."""
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        ref_get_config(arch, "reduced"))
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    ref_cache = ref_model.init_cache(2, 16)
    cache = model.init_cache(2, 16, device="cpu")
    ref_serve = jax.jit(ref_step.make_serve_step(ref_model))
    serve = make_serve_step(model)
    for t in range(toks.shape[1]):
        want, ref_cache = ref_serve(params_np, ref_cache,
                                    jnp.asarray(toks[:, t]))
        got, cache = serve(params, cache, torch.from_numpy(toks[:, t]).long())
        assert_close(got, want, rtol=1e-5, atol=1e-6, msg=f"token {t}")


# ------------------------------------------------------------------ FLOPs
@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "xlstm", "zamba",
                                    "whisper"])
def test_train_flops_match_reference_walker(runs, family):
    """One train step of each family's reduced config (attention blocks
    that divide the lengths, 2 x 32 tokens, fixed rank 4, a 1 x 1 mesh):
    the port's counted FLOPs within 2% of ``analyze_hlo`` on the
    reference's compiled step. Equal to the FLOP for five families;
    xLSTM's differ by 131072 (5e-4: ROADMAP, slice 13)."""
    got = runs.job("port", "port_flops")[family]
    want = runs.job("ref", "ref_flops")[family]
    assert got == pytest.approx(want, rel=0.02)


@pytest.mark.parametrize("family", list(SPLIT_ARCHS))
def test_train_flops_per_chip_at_2x2_match_reference_walker(runs, family):
    """The per-chip count under a model axis: one train step at a fake
    (data 2, model 2) world, 2 x 32 tokens a data rank, against
    ``analyze_hlo`` on the reference's step compiled over an Auto-axis
    2 x 2 mesh, within the 1 x 1 test's 2%. Exact for all but xLSTM
    (65,536 FLOP, 5e-4, over). The families left out run a part whole on
    every model rank (ROADMAP, slice 13 deviations)."""
    got = runs.job("port_2x2", "port_flops_2x2")[family]
    want = runs.job("ref_2x2", "ref_flops_2x2")[family]
    assert got == pytest.approx(want, rel=0.02)


# ------------------------------------------------------- DP all-reduce bytes
def test_allreduce_bytes_at_data_4_equal_the_plan_by_hand(runs):
    """The reduced qwen2-0.5b at a fake (data 4, model 1) world, fixed rank
    4, fp32: every all-reduce byte a rank sends, reckoned from the leaf
    shapes."""
    got = runs.job("port", "port_allreduce4")
    cfg = get_config("qwen2-0.5b", "reduced")
    params = build_model(cfg).init(0, "cpu")
    leaves = classify_leaves(params, cfg.num_layers, cfg.num_stages,
                             min_dim=128)
    plan = make_plan("fixed", leaves, stage_ranks=[RANK] * cfg.num_stages,
                     fixed_rank=RANK, num_stages=cfg.num_stages)
    ranks = plan.as_dict()
    factors = flat = 0
    for path, p in tree.flatten_with_path(params):
        if path in ranks:       # P (E, m, r) and Q (E, n, r), fp32
            *lead, m, n = p.shape
            factors += 4 * math.prod(lead) * (m + n) * ranks[path]
        else:                   # the flat buckets, in the leaves' fp32
            flat += 4 * p.numel()
    n_leaves = len(tree.leaves(params))
    moments = 4 * 3 * sum(1 for p in tree.leaves(params) if p.numel() > 16)
    # the loss's and the EF norm's DP means
    scalars = 4 * 2
    # model-group sums at model size 1, which the port runs there too: the
    # clip's per-leaf sums of squares and the vocab-parallel lookup's
    # output (this rank's 2 x 32 tokens x d_model)
    norms = 4 * n_leaves
    lookup = 4 * 2 * 32 * cfg.d_model
    assert got["compressed_leaves"] == len(ranks) == 5
    assert got["collective_bytes"] == {
        "all-reduce": factors + flat + moments + scalars + norms + lookup}


# ---------------------------------------------------------- record_summary
RECORDS = {
    "ok": {"arch": "a", "shape": "s", "flops_per_chip": 1.0,
           "bytes_per_chip": 2.0, "collective_total": 3, "compile_s": 4.5,
           "policy": "edgc", "compressed_leaves": 7, "guarded": True,
           "memory": {"argument_bytes": 10, "temp_bytes": 5,
                      "code_bytes": None}},
    "pipeline": {"arch": "a", "shape": "s", "flops_per_chip": 1.0,
                 "memory": {"argument_bytes": 1, "temp_bytes": 2},
                 "pipeline": {"num_stages": 2, "schedule": "1f1b",
                              "stash_policy": "replay",
                              "stage_bytes": [[1, 2], [3, 4]],
                              "peak_activation_bytes": [5, 6],
                              "overlap": {"chunk_bytes": 0,
                                          "in_loop_chunks": [0, 1],
                                          "residual_chunks": [1, 0],
                                          "feasible": [True, True]}}},
    "outer": {"arch": "a", "shape": "s", "flops_per_chip": 1.0,
              "outer_sync": {"wire_bytes_compressed": 8,
                             "wire_bytes_full": 9, "outer_k": 2,
                             "outer_rank": 32,
                             "collective_cross_pod": None}},
    "outer_skipped": {"arch": "a", "shape": "s", "flops_per_chip": 1.0,
                      "outer_sync": {"skipped": True, "reason": "r"}},
    "skipped": {"arch": "a", "shape": "s", "skipped": True,
                "reason": "pipeline: no adapter"},
    "failed": {"arch": "a", "shape": "s", "error": "boom",
               "traceback": "..."},
}


@pytest.mark.parametrize("case", sorted(RECORDS))
def test_record_summary_equals_reference(case):
    rec = RECORDS[case]
    assert dryrun.record_summary(rec) == _ref_dryrun().record_summary(rec)


# ------------------------------------------------------------- outer sync
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-7b"])
def test_outer_sync_wire_bytes_equal_reference(arch):
    """The outer sync's record at the reduced config, 2 pods, rank 8: its
    compressed and full wire bytes and compressed leaves are the
    reference's ``plan_wire_bytes`` of the same plan (fp32 deltas)."""
    cfg = get_config(arch, "reduced")
    rec = dryrun._lower_outer_sync(cfg, build_model(cfg), 2, 8)
    ref_cfg = ref_get_config(arch, "reduced")
    shapes = jax.eval_shape(ref_build_model(ref_cfg).init,
                            jax.random.PRNGKey(0))
    leaves = ref_classify_leaves(shapes, ref_cfg.num_layers, 1, min_dim=128)
    plan = ref_make_plan("fixed", leaves, fixed_rank=8, num_stages=1)
    compressed, full = ref_plan_wire_bytes(leaves, plan, 4)
    assert (rec["wire_bytes_compressed"], rec["wire_bytes_full"]) == (
        compressed, full)
    assert rec["compressed_leaves"] == len(plan.ranks) > 0
    assert rec["collective_cross_pod"] is None and rec["flops_per_chip"] > 0


# -------------------------------------------------------------------- CLI
@pytest.mark.parametrize("kind", sorted(CLI))
def test_cli_on_cpu_prints_ok_lines(runs, kind):
    """``python -m repro_torch.launch.dryrun --device cpu --arch
    qwen2-0.5b`` at the published widths on the 16 x 16 mesh (2 x 8 x 16
    with ``--pipe 2``): exit 0, one OK line with the per-chip terms."""
    rc, out, err = runs.get(kind)
    assert rc == 0, (out[-2000:], err[-3000:])
    ok = [l for l in out.splitlines() if l.startswith("OK ")]
    assert len(ok) == 1, out
    for term in ("FLOP/chip", "B/chip", "MiB/chip", "GiB/chip"):
        assert term in ok[0]
    mesh = "[2x8x16]" if kind == "pipe2" else "[16x16]"
    assert f"qwen2-0.5b x {CLI[kind][1]} {mesh}" in ok[0]
    if kind == "pipe2":
        assert "dense stage-sync [" in ok[0]
    assert "done: 1 ok, 0 skipped, 0 failed" in out


def test_default_device_needs_cuda():
    """The default device is cuda: without a CUDA build the dry run stops
    with a clear error before it makes a fake tensor."""
    if torch.cuda.is_available():
        pytest.skip("this torch has CUDA: the default device runs")
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        dryrun.lower_one("qwen2-0.5b", "decode_32k")
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k"])


def test_lower_one_skips_as_the_reference():
    """The reference's skip reasons: long_500k without a long config, and
    a pipeline mesh for a non-train shape."""
    rec = dryrun.lower_one("whisper-base", "long_500k", device="cpu")
    assert rec["skipped"] and "long_500k inapplicable" in rec["reason"]
    rec = dryrun.lower_one("qwen2-0.5b", "decode_32k", pipe=2, device="cpu")
    assert rec == {"arch": "qwen2-0.5b", "shape": "decode_32k",
                   "skipped": True,
                   "reason": "pipeline mesh applies to train shapes only"}
