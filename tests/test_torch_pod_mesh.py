"""The ``pod`` axis of the training mesh against the reference.

``make_host_mesh(pod=P, ...)`` puts a ``pod`` axis outermost, as the
reference's does, and each pod is a data-parallel island: the DP group is
pod x data, flattened pod-major. The reference's ``Trainer`` runs on
Auto-axis pod meshes of 4 fake CPU devices in three subprocesses: the flat
step on ``(pod 2, data 2, model 1)``, the ``dp_tp`` step on ``(pod 2, data
1, model 2)`` and the pipelined step on ``(pod 2, pipe 2, data 1, model
1)``; each writes its starting checkpoint first (and the ``dp_tp`` run its
starting state), then runs 3 steps and writes its final checkpoint. The
port's gloo worlds start as soon as the starting states exist:

* four processes: every pod layout's axes, rank order and DP groups; the
  flat trainer on ``(pod 2, data 2)`` from the reference's start, held to
  the reference at ``tests/test_torch_trainer.py``'s bars (losses 5e-3,
  bytes equal, weights rtol 1e-3 / atol 1e-4; EF and |Q| of every worker,
  pod-major, at rtol 2e-3 / atol 3e-4), and bit-equal to the same run on
  ``(data 4)``; the ``dp_tp`` trainer on ``(pod 2, data 1, model 2)``
  from ``from_reference(..., mesh=)`` (which takes the pod-major worker's
  compressor replica), held at ``tests/test_distributed.py``'s bars
  (losses 1e-4; EF and |Q| rtol 2e-3 / atol 3e-4; each leaf's change
  within 1e-2 of the reference's, relative in norm); the pipelined trainer
  on ``(pod 2, pipe 2, data 1)`` at ``tests/test_torch_pipeline_tp.py``'s
  bars (the same, on each stage's live compressor slices);
* two processes: a checkpoint written at ``(pod 2, data 1)`` restored bit
  for bit at ``(data 2)`` (W is 2 in both) and stepped on; ``make_dp_psum``
  over the two.

About 50 s alone on an 8-core CPU.
"""
import dataclasses
import json
import os
import pickle
import textwrap
import time

import numpy as np
import pytest

from test_torch_pipeline_tp import _load
from test_torch_tp import _env, _free_port, _wait
from test_torch_tp_families import _start

MODEL = dict(name="t", family="dense", num_layers=4, d_model=128, num_heads=4,
             num_kv_heads=4, d_ff=256, vocab_size=512, norm="layernorm",
             act="gelu_plain", pos="learned", tie_embeddings=True,
             max_position=64, num_stages=4)
DATA = dict(vocab_size=512, seq_len=32, batch_size=4, seed=3)
STEPS = 3
# (name, mesh sizes, pipelined): the reference's runs, one subprocess each
REF_RUNS = [("flat", dict(pod=2, data=2, model=1), False),
            ("dp_tp", dict(pod=2, data=1, model=2), False),
            ("pipe", dict(pod=2, pipe=2, data=1, model=1), True)]
# the pod layouts the four-process world builds
LAYOUTS = [dict(pod=2, data=2), dict(pod=2, data=1, model=2),
           dict(pod=2, pipe=2, data=1), dict(pod=2, pipe=2, data=1, model=1),
           dict(pod=1, data=4), dict(pod=1, pipe=2, data=2)]
# each leaf's change over the run against the reference's, relative in norm
DELTA_BAR = 1e-2

# Both packages' configs, by package name.
_COMMON = textwrap.dedent("""
    import dataclasses, json, os, pickle, sys, time
    import numpy as np

    def setup(pkg, pipelined, model_kw, data_kw, steps, hw):
        core = __import__(pkg + ".core", fromlist=["EDGCConfig"])
        data = __import__(pkg + ".data.pipeline", fromlist=["SyntheticLM"])
        adam = __import__(pkg + ".optim.adam", fromlist=["AdamConfig"])
        mm = __import__(pkg + ".models.model", fromlist=["build_model"])
        tr = __import__(pkg + ".train.trainer", fromlist=["TrainerConfig"])
        S = 2 if pipelined else model_kw["num_stages"]
        cfg = mm.ModelConfig(**dict(model_kw, num_stages=S))
        kw = {}
        if pkg == "repro_torch":
            # the reference's comm model prices a TPU v5e
            from repro_torch.core.comm_model import HardwareSpec
            kw["hw"] = HardwareSpec(**hw)
        edgc = core.EDGCConfig(policy="fixed", fixed_rank=8, num_stages=S,
                               total_iterations=steps,
                               gds=core.GDSConfig(alpha=0.5, beta=0.25),
                               **kw)
        tcfg = tr.TrainerConfig(total_steps=steps, log_every=1,
                                num_microbatches=2 if pipelined else 0,
                                adam=adam.AdamConfig(lr=1e-3, warmup_steps=2,
                                                     total_steps=steps))
        batches = lambda: data.SyntheticLM(**data_kw).batches()
        return mm.build_model(cfg), edgc, tcfg, batches

    def record(hist):
        return {k: [h[k] for h in hist] for k in
                ("loss", "bytes_synced", "bytes_full", "stage_bytes", "ranks",
                 "lr")}
""")

_REF_SCRIPT = _COMMON + textwrap.dedent("""
    import jax
    from jax.sharding import AxisType, Mesh
    from repro.train.trainer import Trainer
    args = pickle.loads(bytes.fromhex(sys.argv[1]))
    name, sizes, pipelined = args["run"]
    model, edgc, tcfg, batches = setup("repro", pipelined, args["model"],
                                       args["data"], args["steps"], None)
    shape = tuple(sizes.values())
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = Mesh(devs, tuple(sizes), axis_types=(AxisType.Auto,) * len(shape))
    tr = Trainer(model, mesh, edgc, tcfg, seed=0)
    out = os.path.join(args["out"], name)
    tr.save_checkpoint(out + "_start", step=0)
    state = jax.device_get(tr.state)
    # plain tuples for the compressor's (q, err) pairs: the port's side
    # unpickles it without the reference package
    state["comp"] = {k: tuple(v) if isinstance(v, tuple) else v
                     for k, v in state["comp"].items()}
    with open(out + "_state.pkl", "wb") as f:
        pickle.dump(state, f)
    open(out + "_ready", "w").close()
    hist = tr.run(batches(), num_steps=args["steps"])
    tr.save_checkpoint(out + "_end", step=args["steps"])
    with open(out + ".json", "w") as f:
        json.dump(dict(record(hist), savings=tr.comm_savings(),
                       world=tr.world), f)
    print("REF_POD_OK")
""")

_PORT_SCRIPT = _COMMON + textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.dist.collectives import make_dp_psum
    from repro_torch.interop import from_reference
    from repro_torch.launch.mesh import dp_group, dp_index, make_host_mesh
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train.step import full_state
    from repro_torch.train.trainer import Trainer
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    args = pickle.loads(bytes.fromhex(sys.argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    ref, tmp = args["ref"], args["out"]

    def ready(name):
        path = os.path.join(ref, name)
        for _ in range(3000):
            if os.path.exists(path + "_ready"):
                return path
            time.sleep(0.2)
        raise TimeoutError(path)

    def trainer(sizes, pipelined):
        model, edgc, tcfg, batches = setup("repro_torch", pipelined,
                                           args["model"], args["data"],
                                           args["steps"], args["hw"])
        mesh = make_host_mesh(device_type="cpu", **sizes)
        pipe = sizes.get("pipe") if pipelined else None
        return Trainer(model, edgc, tcfg, seed=0, device="cpu", pipe=pipe,
                       mesh=mesh), batches, mesh

    def run(tag, tr, batches):
        hist = tr.run(batches(), num_steps=args["steps"])
        tr.save_checkpoint(os.path.join(tmp, tag + "_end"),
                           step=args["steps"])
        return dict(record(hist), savings=tr.comm_savings(), world=tr.world)

    out = {}
    if world == 4:
        for sizes in args["layouts"]:
            mesh = make_host_mesh(device_type="cpu", **sizes)
            names = mesh.mesh_dim_names
            row = {"names": list(names), "ranks": mesh.mesh.tolist(),
                   "dp": dist.get_process_group_ranks(dp_group(mesh)),
                   "dp_index": dp_index(mesh)}
            if "pipe" in names:
                row["pipe"] = dist.get_process_group_ranks(
                    mesh.get_group("pipe"))
            gathered = [None] * world
            dist.all_gather_object(gathered, row)
            out["layout/" + "x".join(f"{k}{v}" for k, v in sizes.items())] = \\
                gathered
        start = ready("flat") + "_start"
        for tag, sizes in (("flat_pod", dict(pod=2, data=2)),
                           ("flat_data", dict(data=4))):
            tr, batches, _ = trainer(sizes, False)
            tr.restore_checkpoint(start)
            out[tag] = run(tag, tr, batches)
        # dp_tp: the reference's starting state through from_reference
        path = ready("dp_tp")
        with open(path + "_state.pkl", "rb") as f:
            ref_state = pickle.load(f)
        tr, batches, mesh = trainer(dict(pod=2, data=1, model=2), False)
        tr.state = from_reference(ref_state, "cpu", mesh=mesh)
        w = dp_index(mesh)
        comp = full_state(tr.state["comp"])
        picked = [bool(np.array_equal(comp[key].q.numpy(), q[w])
                       and np.array_equal(comp[key].err.numpy(), err[w]))
                  for key, (q, err) in ref_state["comp"].items()]
        gathered = [None] * world
        dist.all_gather_object(gathered, (w, all(picked), len(picked)))
        out["from_reference"] = gathered
        out["dp_tp"] = run("dp_tp", tr, batches)
        tr, batches, _ = trainer(dict(pod=2, pipe=2, data=1), True)
        tr.restore_checkpoint(ready("pipe") + "_start")
        out["pipe"] = dict(run("pipe", tr, batches),
                           d_of_stage=list(tr._splans.d_of_stage))
    else:
        # a checkpoint of (pod 2, data 1) restored at (data 2)
        tr, batches, _ = trainer(dict(pod=2, data=1), False)
        data = batches()
        tr.run(data, num_steps=2)
        path = os.path.join(tmp, "pod2x1")
        tr.save_checkpoint(path, step=2)
        back, _, _ = trainer(dict(data=2), False)
        step = back.restore_checkpoint(path)
        saved, _ = ckpt_mod.restore(path, back._checkpoint_like(gather=False))
        whole = back._checkpoint_like(gather=True)
        equal = all(torch.equal(a, b) for a, b in
                    zip(tree.leaves(whole), tree.leaves(saved)))
        more = back.run(data, num_steps=1)
        out["restore"] = {"step": step, "equal": equal,
                          "leaves": len(tree.leaves(saved)),
                          "world": back.world,
                          "loss": [h["loss"] for h in more]}
        x = {"a": torch.arange(3.0) + rank, "b": torch.ones(2, 2) * rank}
        before = tree.tree_map(torch.clone, x)
        total = make_dp_psum(dp_group(make_host_mesh(
            pod=2, data=1, device_type="cpu")))(x)
        out["psum"] = {"a": total["a"].tolist(), "b": total["b"].tolist(),
                       "kept": all(torch.equal(x[k], before[k]) for k in x)}
    if rank == 0:
        with open(os.path.join(tmp, f"port{world}.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's three runs and the port's two worlds, all at once
    (the port waits for each reference run's starting state)."""
    tmp = tmp_path_factory.mktemp("pod")
    ref_dir, port_dir = tmp / "ref", tmp / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    from repro.core import comm_model
    common = dict(model=MODEL, data=DATA, steps=STEPS,
                  hw=dataclasses.asdict(comm_model.TPU_V5E))
    ref_env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=4")
    t0 = time.perf_counter()
    refs = [_start(_REF_SCRIPT, [pickle.dumps(dict(
        common, run=r, out=str(ref_dir))).hex()], env=ref_env)
        for r in REF_RUNS]

    def world(w):
        port = _free_port()
        blob = pickle.dumps(dict(common, layouts=LAYOUTS, ref=str(ref_dir),
                                 out=str(port_dir))).hex()
        return [_start(_PORT_SCRIPT, [str(k), str(w), str(port), blob])
                for k in range(w)]
    worlds = {w: world(w) for w in (2, 4)}
    for procs in worlds.values():
        _wait(procs, 600)
    assert _wait(refs, 600).count("REF_POD_OK") == len(REF_RUNS)
    print(f"pod runs: {time.perf_counter() - t0:.1f} s")
    port = {}
    for w in worlds:
        port.update(json.loads((port_dir / f"port{w}.json").read_text()))
    ref = {name: json.loads((ref_dir / f"{name}.json").read_text())
           for name, _, _ in REF_RUNS}
    return ref_dir, port_dir, ref, port


def _expected_layout(sizes: dict) -> dict:
    """Each rank's pod-major DP peers, DP index and pipe peers, worked out
    from rank = ((p * pipe + s) * data + w) * model + t."""
    P, S, D, M = (sizes.get(k, 1) for k in ("pod", "pipe", "data", "model"))
    out = []
    for p in range(P):
        for s in range(S):
            for w in range(D):
                for t in range(M):
                    r = ((p * S + s) * D + w) * M + t
                    dp = [((pp * S + s) * D + ww) * M + t
                          for pp in range(P) for ww in range(D)]
                    pipe = [((p * S + ss) * D + w) * M + t for ss in range(S)]
                    out.append((r, {"dp": dp, "dp_index": p * D + w,
                                    "pipe": pipe}))
    return dict(out)


@pytest.mark.parametrize("sizes", LAYOUTS,
                         ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
def test_pod_layouts_rank_order_and_dp_groups(runs, sizes):
    """The reference's axes in its order (pod outermost, a pod axis of
    size 1 too), rank = ((p * pipe + s) * data + w) * model + t, and each
    process's DP group its stage's pod x data peers, pod-major."""
    rows = runs[3]["layout/" + "x".join(f"{k}{v}" for k, v in sizes.items())]
    names = [k for k in ("pod", "pipe", "data", "model") if k in sizes]
    want = _expected_layout(sizes)
    shape = [sizes[k] for k in names]
    for rank, row in enumerate(rows):
        assert row["names"] == names
        assert row["ranks"] == np.arange(4).reshape(shape).tolist()
        assert row["dp"] == want[rank]["dp"], (rank, row)
        assert row["dp_index"] == want[rank]["dp_index"]
        if "pipe" in sizes:
            assert row["pipe"] == want[rank]["pipe"]


def _hist_match(got: dict, want: dict, loss_bar: float) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                               atol=loss_bar)
    for key in ("bytes_synced", "bytes_full", "stage_bytes", "ranks"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    assert got["savings"] == pytest.approx(want["savings"], abs=1e-12)
    assert got["world"] == want["world"]


def _comp_match(name: str, a: np.ndarray, b: np.ndarray, live=None) -> None:
    if name.endswith(".q"):
        a, b = np.abs(a), np.abs(b)
    if live is not None:
        a, b = a[live], b[live]
    np.testing.assert_allclose(a.astype(np.float64), b, rtol=2e-3, atol=3e-4,
                               err_msg=name)


def test_flat_pod_trainer_matches_reference(runs):
    """(pod 2, data 2): world 4, every worker's EF and |Q| in the
    reference's pod-major (W, ...) layout."""
    ref_dir, port_dir, ref, port = runs
    got, want = port["flat_pod"], ref["flat"]
    assert got["world"] == 4
    _hist_match(got, want, 5e-3)
    end, ref_end = _load(str(port_dir / "flat_pod_end")), _load(
        str(ref_dir / "flat_end"))
    assert sorted(end) == sorted(ref_end)
    for name, b in ref_end.items():
        a = end[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name.startswith("['comp']"):
            assert a.shape[0] == 4
            _comp_match(name, a, b)
        elif name.startswith("['params']"):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4,
                                       err_msg=name)


def test_flat_pod_trainer_bit_equal_to_data_axis_alone(runs):
    """(pod 2, data 2) and (data 4) are one DP group of the same four
    processes in the same order: losses and every checkpoint leaf equal."""
    _, port_dir, _, port = runs
    assert port["flat_pod"] == port["flat_data"]
    a, b = _load(str(port_dir / "flat_pod_end")), _load(
        str(port_dir / "flat_data_end"))
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _changes_match(ref_dir, port_dir, tag: str, ref_tag: str,
                   d_of_stage=None) -> None:
    start = _load(str(ref_dir / f"{ref_tag}_start"))
    ref_end = _load(str(ref_dir / f"{ref_tag}_end"))
    end = _load(str(port_dir / f"{tag}_end"))
    assert sorted(end) == sorted(ref_end)
    for name, b in ref_end.items():
        a = end[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name.startswith("['comp']"):
            live = None
            if d_of_stage is not None:
                d = int(name.split("['p", 1)[1].split(":", 1)[0])
                live = [s for s, ds in enumerate(d_of_stage) if ds == d]
                assert live, name
            _comp_match(name, a, b, live)
        elif a.dtype.kind == "f":
            d_ref = b.astype(np.float64) - start[name]
            d_port = a.astype(np.float64) - start[name]
            if not np.linalg.norm(d_ref):
                np.testing.assert_array_equal(a, b, err_msg=name)
                continue
            rel = np.linalg.norm(d_port - d_ref) / np.linalg.norm(d_ref)
            assert rel < DELTA_BAR, (name, rel)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_dp_tp_pod_trainer_matches_reference(runs):
    """(pod 2, data 1, model 2): the tensor-parallel step with its DP mean
    and per-leaf sync over the two pods."""
    ref_dir, port_dir, ref, port = runs
    assert port["dp_tp"]["world"] == 2
    _hist_match(port["dp_tp"], ref["dp_tp"], 1e-4)
    _changes_match(ref_dir, port_dir, "dp_tp", "dp_tp")


def test_from_reference_takes_the_pod_major_worker(runs):
    """On (pod 2, data 1, model 2) ranks 0, 1 are pod 0 and ranks 2, 3
    pod 1: each takes worker p * data + w of the reference's (W, ...)
    compressor state."""
    rows = runs[3]["from_reference"]
    assert [r[0] for r in rows] == [0, 0, 1, 1]
    assert all(r[1] and r[2] > 0 for r in rows), rows


def test_pipelined_pod_trainer_matches_reference(runs):
    """(pod 2, pipe 2, data 1): each stage's DP group is its two pods'
    processes; DistPipe on the pipe group."""
    ref_dir, port_dir, ref, port = runs
    got = port["pipe"]
    assert got["world"] == 2
    _hist_match(got, ref["pipe"], 1e-4)
    _changes_match(ref_dir, port_dir, "pipe", "pipe", got["d_of_stage"])


def test_pod_checkpoint_restores_on_the_data_axis(runs):
    """A checkpoint of (pod 2, data 1) holds two compressor replicas, as
    one of (data 2) does: a (data 2) trainer restores it bit for bit at
    its step and steps on."""
    got = runs[3]["restore"]
    assert got["step"] == 2 and got["equal"] and got["world"] == 2
    assert got["leaves"] > 0
    assert len(got["loss"]) == 1 and np.isfinite(got["loss"]).all()


def test_dp_psum_over_two_processes(runs):
    """``make_dp_psum`` sums over the pod x data group and leaves its
    input alone."""
    got = runs[3]["psum"]
    assert got["a"] == [1.0, 3.0, 5.0]
    assert got["b"] == [[1.0, 1.0], [1.0, 1.0]]
    assert got["kept"]
