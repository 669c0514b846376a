"""Tensor parallelism (the ``model`` mesh axis) against the reference.

The reference runs its ``dp_tp`` and ``auto`` steps on Auto-axis meshes of
8 fake CPU devices in a subprocess, as ``tests/test_distributed.py`` does;
the port runs the same steps in gloo processes, one per mesh device, from
the same starting state (``interop.from_reference(..., mesh=)``) on the
same ``SyntheticLM`` batches, under AdamW at lr 1e-3 from the first step.
The port at 2x2 is held to the reference at 2x2. At data 1 and model > 1
the reference's ``dp_tp`` step does not compile (XLA: "Cross-partition
allreduce must be in (partial) manual partitioning mode", ROADMAP Queue 3),
so the port at 1x2 and 1x4 is held to the reference's 1x1. The bars:
losses, entropies, EF and |Q| at test_distributed.py's (1e-4; rtol 2e-3 /
atol 3e-4), and each parameter's change over the run within 1e-2 of the
reference's, relative in norm.

The configs: test_distributed.py's dense config, a GQA config whose two KV
heads split inside a head at model 4 (qwen2.5-smoke), a tied GPT-2 config
(the vocab-parallel embedding), the reduced MoE (expert parallelism) and,
for ``auto``, a dense config whose embedding (2^20 elements) is large
enough for FSDP.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    "dense": dict(name="d", family="dense", num_layers=2, d_model=128,
                  num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
                  num_stages=2),
    "gqa": dict(name="qwen2.5-smoke", family="dense", num_layers=2,
                d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
                vocab_size=512, qkv_bias=True, tie_embeddings=True),
    "gpt2": dict(name="t", family="dense", num_layers=2, d_model=128,
                 num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512,
                 norm="layernorm", act="gelu_plain", pos="learned",
                 tie_embeddings=True, max_position=64, num_stages=2),
    "moe": dict(name="qwen3-moe-smoke", family="moe", num_layers=2,
                d_model=256, num_heads=4, num_kv_heads=2, d_ff=256,
                vocab_size=512, num_experts=4, experts_per_token=2),
    "auto": dict(name="a", family="dense", num_layers=2, d_model=128,
                 num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=8192,
                 num_stages=2),
}
STEPS, BATCH, SEQ = 2, 8, 32
# the checkpoint trainer's optimizer: AdamW at lr 1e-3 from the first step,
# under which a step moves a weight by about 1e-3
ADAM = dict(lr=1e-3, warmup_steps=1, total_steps=4)
# each leaf's change over the run against the reference's, relative in norm
# (the largest seen: 4.0e-3, the auto run's embedding, where one element of
# 2^20 moves the other way)
DELTA_BAR = 1e-2

# (config, data, model, mode): what each package runs; the reference's
# runs in three subprocesses at once
REF_RUNS = [[("dense", 1, 1, "dp_tp"), ("dense", 2, 2, "dp_tp"),
             ("gqa", 1, 1, "dp_tp")],
            [("gpt2", 1, 1, "dp_tp"), ("gpt2", 2, 2, "dp_tp"),
             ("auto", 2, 2, "auto"), ("auto", 1, 4, "auto")],
            [("moe", 1, 1, "dp_tp"), ("moe", 2, 2, "dp_tp"),
             ("moe", 2, 2, "auto")]]
PORT_RUNS = {2: [("dense", 1, 2, "dp_tp"), ("gpt2", 1, 2, "dp_tp"),
                 ("moe", 1, 2, "dp_tp")],
             4: [("dense", 1, 4, "dp_tp"), ("gqa", 1, 4, "dp_tp"),
                 ("dense", 2, 2, "dp_tp"),
                 ("gpt2", 2, 2, "dp_tp"), ("moe", 2, 2, "dp_tp"),
                 ("auto", 2, 2, "auto"), ("auto", 1, 4, "auto"),
                 ("moe", 2, 2, "auto")]}
# the trainer whose checkpoints the two-process world writes and restores
TRAINER_MODEL, TRAINER_STEPS = CONFIGS["gpt2"], 2
TRAINER_DATA = dict(vocab_size=512, seq_len=32, batch_size=4, seed=3)


def _key(run) -> str:
    return "{}/{}x{}/{}".format(*run)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")


# The reference's initial state and results. Plans come from each
# package's own classify_leaves/make_plan (the same paths and ranks).
_REF_COMMON = textwrap.dedent("""
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.core import classify_leaves, make_plan
    from repro.core.compressor import NO_COMPRESSION, init_compressor_state
    from repro.models.model import ModelConfig, build_model
    from repro.optim import adam
    from repro.train.step import replicate_comp_state

    def ref_state(kw, mode, adam_kw):
        cfg = ModelConfig(**kw)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        plan = (make_plan("fixed", classify_leaves(params, cfg.num_layers, 2,
                                                   min_dim=64), fixed_rank=8)
                if mode == "dp_tp" else NO_COMPRESSION)
        ost = adam.init(params, adam.AdamConfig(**adam_kw))
        comp = replicate_comp_state(
            init_compressor_state(params, plan, jax.random.PRNGKey(1)), 2)
        return model, plan, {"params": params, "opt_m": ost.m,
                             "opt_v": ost.v, "opt_step": ost.step,
                             "comp": comp}
""")

_REF_SCRIPT = _REF_COMMON + textwrap.dedent("""
    import os, pickle, sys
    from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P
    from repro.data.pipeline import SyntheticLM
    from repro.train.step import (TrainStepConfig, batch_shardings,
                                  make_train_step, state_shardings)
    args = pickle.loads(bytes.fromhex(sys.argv[1]))
    out = {}
    for name, d, m, mode in args["runs"]:
        model, plan, state = ref_state(args["configs"][name], mode,
                                       args["adam"])
        devs = np.array(jax.devices()[:d * m]).reshape(d, m)
        mesh = Mesh(devs, ("data", "model"),
                    axis_types=(AxisType.Auto,) * 2)
        scfg = TrainStepConfig(mode=mode, policy_plan=plan, remat=False,
                               adam=adam.AdamConfig(**args["adam"]))
        step = make_train_step(model, mesh, scfg)
        if mode == "auto":
            state = dict(state, comp={})
        else:
            state = dict(state, comp=jax.tree_util.tree_map(
                lambda a: a[:d], state["comp"]))
        sshard = state_shardings(state, model, mesh, fsdp=(mode == "auto"))
        data = SyntheticLM(args["configs"][name]["vocab_size"], args["seq"],
                           args["batch"], seed=0).batches()
        jstep = None
        start = {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in
                 jax.tree_util.tree_flatten_with_path(state["params"])[0]}
        st = jax.device_put(state, sshard)
        losses, ents = [], []
        for _ in range(args["steps"]):
            batch = {k: jnp.asarray(v) for k, v in next(data).items()}
            bshard = batch_shardings(batch, mesh, args["batch"])
            if jstep is None:
                jstep = jax.jit(step, in_shardings=(sshard, bshard),
                                out_shardings=(sshard, NamedSharding(mesh, P())))
            st, mets = jstep(st, jax.device_put(batch, bshard))
            losses.append(float(mets["loss"]))
            ents.append(float(mets["entropy"]))
        st = jax.device_get(st)
        params = {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in
                  jax.tree_util.tree_flatten_with_path(st["params"])[0]}
        comp = {k: (np.asarray(v.q)[0], np.asarray(v.err)[0])
                for k, v in st["comp"].items()}
        out["{}/{}x{}/{}".format(name, d, m, mode)] = {
            "loss": losses, "entropy": ents, "params": params, "comp": comp,
            "delta": {k: params[k] - start[k] for k in params}}
    with open(args["out"], "wb") as f:
        pickle.dump(out, f)
    print("REF_TP_OK")
""")

_PORT_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import tree
    from repro_torch.core import classify_leaves, make_plan
    from repro_torch.core.compressor import NO_COMPRESSION
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.interop import from_reference
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.step import (TrainStepConfig, full_state,
                                        make_train_step)
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    args = pickle.loads(bytes.fromhex(sys.argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    with open(args["init"], "rb") as f:
        init = pickle.load(f)
    out = {}
    for name, d, m, mode in args["runs"]:
        cfg = ModelConfig(**args["configs"][name])
        model = build_model(cfg)
        mesh = make_host_mesh(data=d, model=m, device_type="cpu")
        state = from_reference(init[(name, mode)], "cpu", mesh=mesh,
                               fsdp=(mode == "auto"))
        if mode == "auto":
            state["comp"] = {}
        plan = (make_plan("fixed", classify_leaves(
                    from_reference(init[(name, mode)])["params"],
                    cfg.num_layers, 2, min_dim=64), fixed_rank=8)
                if mode == "dp_tp" else NO_COMPRESSION)
        scfg = TrainStepConfig(mode=mode, policy_plan=plan, bucketed=False,
                               remat=False, adam=AdamConfig(**args["adam"]))
        step = make_train_step(model, scfg, mesh=mesh)
        w = mesh.get_local_rank("data")
        per = args["batch"] // d
        data = SyntheticLM(cfg.vocab_size, args["seq"], args["batch"],
                           seed=0).batches()
        start = {p: v.clone() for p, v in
                 tree.flatten_with_path(full_state(state)["params"])}
        losses, ents, counts = [], [], None
        for _ in range(args["steps"]):
            batch = {k: torch.as_tensor(v[w * per:(w + 1) * per]).long()
                     for k, v in next(data).items()}
            if counts is None:
                # the collectives of the first step, by kind
                comm = CommDebugMode()
                with comm:
                    state, mets = step(state, batch)
                counts = {str(k).split(".")[-1]: v for k, v in
                          comm.get_comm_counts().items()}
            else:
                state, mets = step(state, batch)
            losses.append(float(mets["loss"]))
            ents.append(float(mets["entropy"]))
        full = full_state(state)
        every = [None] * world
        dist.all_gather_object(every, counts)
        if rank == 0:
            params = {p: v.numpy() for p, v in
                      tree.flatten_with_path(full["params"])}
            out["{}/{}x{}/{}".format(name, d, m, mode)] = {
                "loss": losses, "entropy": ents, "params": params,
                "delta": {p: v - start[p].numpy() for p, v in params.items()},
                "collectives": every,
                "comp": {k: (v.q.numpy(), v.err.numpy())
                         for k, v in full["comp"].items()}}
    if args.get("unit"):
        out["unit"] = unit_checks(rank, world, args)
    if rank == 0:
        with open(args["out"], "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()
""")

# Checks of the two-process world beside its runs: the TP compress of each
# kind of split against the whole leaf's, the split entropy sample, and a
# trainer on a 1x2 mesh that saves a checkpoint, which a fresh one restores.
_UNIT_CHECKS = textwrap.dedent("""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.core import EDGCConfig
    from repro_torch.core.entropy import (GDSConfig, grads_entropy,
                                          split_sample, strided_sample,
                                          _sum_over_split)
    from repro_torch.core.powersgd import (LowRankState, compress_leaf,
                                           compress_leaf_tp)
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import sharding
    from repro_torch.dist.collectives import make_model_psum, model_all_gather
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    def unit_checks(rank, world, args):
        res = {}
        mesh = make_host_mesh(data=1, model=world, device_type="cpu")
        grp, t = mesh.get_group("model"), mesh.get_local_rank("model")
        gen = torch.Generator().manual_seed(0)
        cases = {"column": ((2, 64, 96), 2), "row": ((2, 96, 64), 1),
                 "expert": ((2, 4, 64, 96), 1), "replicated": ((64, 96), None)}
        for kernels in (False, True):
            for kind, (shape, dim) in cases.items():
                g = torch.randn(shape, generator=gen)
                e = 0.1 * torch.randn(shape, generator=gen)
                q = torch.randn(shape[:-2] + (shape[-1], 8), generator=gen)
                g_hat, st = compress_leaf(g, LowRankState(q, e),
                                          use_kernels=kernels)
                cut = ((lambda x: x.chunk(world, dim)[t].contiguous())
                       if dim is not None else (lambda x: x))
                lg, lst = compress_leaf_tp(
                    cut(g), LowRankState(q, cut(e)), dim, t, lambda x: x,
                    make_model_psum(grp),
                    lambda x, d: model_all_gather(x, d, grp),
                    use_kernels=kernels)
                res[f"compress/{kind}/{kernels}"] = (
                    rel(lg, cut(g_hat)), rel(lst.err, cut(st.err)),
                    rel(lst.q.abs(), st.q.abs()))
        grads = {"a": torch.randn((6, 64, 96), generator=gen),
                 "b": torch.randn((96, 64), generator=gen),
                 "c": torch.randn((40,), generator=gen)}
        specs = {"a": (None, None, "model"), "b": ("model", None), "c": ()}
        split = sharding.distribute_tree(grads, specs, mesh["model"])
        for est in ("gaussian", "histogram"):
            cfg = GDSConfig(beta=0.25, estimator=est)
            res[f"entropy/{est}"] = (float(grads_entropy(grads, cfg)),
                                     float(grads_entropy(split, cfg)))
        res["sample_equal"] = all(
            torch.equal(_sum_over_split(split_sample(split[k], 0.25)[0],
                                        split[k]),
                        strided_sample(grads[k], 0.25))
            for k in ("a", "b"))
        # a trainer on 1x2 saves; a fresh one restores and steps on
        def trainer(m):
            edgc = EDGCConfig(policy="fixed", fixed_rank=8, num_stages=2,
                              total_iterations=4)
            tcfg = TrainerConfig(total_steps=4, log_every=1, bucketed=False,
                                 adam=AdamConfig(lr=1e-3, warmup_steps=1,
                                                 total_steps=4))
            return Trainer(build_model(ModelConfig(**args["trainer_model"])),
                           edgc, tcfg, seed=0, device="cpu", mesh=m)
        tr = trainer(mesh)
        data = SyntheticLM(**args["trainer_data"]).batches()
        hist = tr.run(data, num_steps=args["trainer_steps"])
        tr.save_checkpoint(args["ckpt"], step=args["trainer_steps"])
        res["trainer_loss"] = [h["loss"] for h in hist]
        other = trainer(mesh)
        other.restore_checkpoint(args["ckpt"])
        saved, _ = ckpt_mod.restore(args["ckpt"],
                                    other._checkpoint_like(gather=False))
        whole = other._checkpoint_like(gather=True)
        res["restored_equal"] = all(
            torch.equal(a, b) for a, b in zip(tree.leaves(whole["params"]),
                                              tree.leaves(saved["params"])))
        res["restored_step"] = other._global_step
        more = other.run(data, num_steps=1)
        res["restored_loss"] = [h["loss"] for h in more]
        return res
""")


_PORT_SCRIPT = _UNIT_CHECKS + _PORT_SCRIPT


def _start(script: str, argv: list[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", script, *argv], env=_env(),
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _port_world(world: int, args: dict) -> list[subprocess.Popen]:
    port = _free_port()
    blob = pickle.dumps(args).hex()
    return [_start(_PORT_SCRIPT, [str(r), str(world), str(port), blob])
            for r in range(world)]


def _wait(procs, timeout: float) -> str:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    return "\n".join(logs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' results, keyed by run; the reference subprocess and
    the two port worlds run at once."""
    tmp = tmp_path_factory.mktemp("tp")
    scope: dict = {}
    exec(_REF_COMMON, scope)
    import jax
    init = {}
    for name, _, _, mode in [r for rs in REF_RUNS for r in rs]:
        if (name, mode) in init:
            continue
        _, _, state = scope["ref_state"](CONFIGS[name], mode, ADAM)
        state = jax.device_get(state)
        state["comp"] = {k: (np.asarray(v.q), np.asarray(v.err))
                         for k, v in state["comp"].items()}
        init[(name, mode)] = state
    with open(tmp / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    common = dict(configs=CONFIGS, adam=ADAM, steps=STEPS, batch=BATCH,
                  seq=SEQ, init=str(tmp / "init.pkl"))
    ref_env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=8")
    refs = [subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT,
         pickle.dumps(dict(common, runs=r, out=str(tmp / f"ref{i}.pkl"))).hex()],
        env=ref_env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i, r in enumerate(REF_RUNS)]
    unit = dict(unit=True, ckpt=str(tmp / "ckpt" / "tp"),
                trainer_model=TRAINER_MODEL, trainer_data=TRAINER_DATA,
                trainer_steps=TRAINER_STEPS)
    worlds = {w: _port_world(w, dict(common, runs=r,
                                     out=str(tmp / f"port{w}.pkl"),
                                     **(unit if w == 2 else {})))
              for w, r in PORT_RUNS.items()}
    for procs in worlds.values():
        _wait(procs, 600)
    assert _wait(refs, 900).count("REF_TP_OK") == len(REF_RUNS)
    ref, port = {}, {}
    for name in [f"ref{i}" for i in range(len(REF_RUNS))]:
        with open(tmp / f"{name}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    for w in worlds:
        with open(tmp / f"port{w}.pkl", "rb") as f:
            port.update(pickle.load(f))
    return ref, port, tmp


def _ref_key(run) -> str:
    """The reference run a port run is held to: the same mesh, or 1x1
    where the reference's dp_tp step does not compile (data 1, model > 1)."""
    name, d, m, mode = run
    if mode == "dp_tp" and d == 1:
        return _key((name, 1, 1, mode))
    return _key(run)


ALL_PORT_RUNS = [r for rs in PORT_RUNS.values() for r in rs]


@pytest.mark.parametrize("run", ALL_PORT_RUNS, ids=_key)
def test_port_step_matches_reference(runs, run):
    ref, port, _ = runs
    want, got = ref[_ref_key(run)], port[_key(run)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["entropy"], want["entropy"], rtol=0,
                               atol=1e-4)
    assert sorted(got["params"]) == sorted(want["params"])
    for path, a in want["delta"].items():
        # each leaf's update, relative in norm: an Adam-normalised
        # near-zero gradient may take the other sign in one element
        b = got["delta"][path]
        assert np.linalg.norm(a) > 0, path
        rel = np.linalg.norm(b - a) / np.linalg.norm(a)
        assert rel < DELTA_BAR, (path, rel)
    assert sorted(got["comp"]) == sorted(want["comp"])
    for path, (q, err) in want["comp"].items():
        gq, gerr = got["comp"][path]
        np.testing.assert_allclose(gerr, err, rtol=2e-3, atol=3e-4,
                                   err_msg=path)
        np.testing.assert_allclose(np.abs(gq), np.abs(q), rtol=2e-3,
                                   atol=3e-4, err_msg=path)


@pytest.mark.parametrize("run", ALL_PORT_RUNS, ids=_key)
def test_port_step_collectives_agree_across_ranks(runs, run):
    """Every process of a world issues the same collectives in a step (by
    CommDebugMode's count of each kind), as gloo and NCCL need; each run
    with a model group of 2 or more issues some. ``pytest -s`` prints the
    counts of the first step."""
    counts = runs[1][_key(run)]["collectives"]
    print(_key(run), counts[0])
    assert all(c == counts[0] for c in counts), counts
    assert sum(counts[0].values()) > 0


@pytest.mark.parametrize("kind", ["column", "row", "expert", "replicated"])
@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_tp_compress_equals_whole_leaf(runs, kind, kernels):
    """ĝ and EF of each shard are the whole leaf's, and every process ends
    with the whole Q (up to column sign), with and without the kernels'
    wrappers (their plain versions on the CPU)."""
    g_hat, err, q = runs[1]["unit"][f"compress/{kind}/{kernels}"]
    assert g_hat < 1e-5 and err < 1e-5 and q < 1e-5, (g_hat, err, q)


def test_split_entropy_equals_unsplit(runs):
    """The sample of a split leaf is the whole leaf's, position for
    position; the Gaussian estimate from moments summed over the split and
    the histogram estimate of the gathered sample agree with the unsplit."""
    unit = runs[1]["unit"]
    assert unit["sample_equal"]
    for est in ("gaussian", "histogram"):
        whole, split = unit[f"entropy/{est}"]
        assert abs(whole - split) < 1e-5, (est, whole, split)


def test_tp_checkpoint_has_the_flat_layout_and_restores_on_another_mesh(runs):
    """A trainer on a 1x2 mesh writes whole tensors in the layout of the
    trainer without a mesh (the reference's), with the same values within
    the bars; a fresh trainer on the 1x2 mesh restores it bit for bit and
    steps on, and so does one without a mesh (model size 1)."""
    import torch
    from repro_torch import tree
    from repro_torch.core import EDGCConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train.trainer import Trainer, TrainerConfig
    _, port, tmp = runs
    unit = port["unit"]
    torch.set_num_threads(1)

    def trainer():
        edgc = EDGCConfig(policy="fixed", fixed_rank=8, num_stages=2,
                          total_iterations=4)
        tcfg = TrainerConfig(total_steps=4, log_every=1, bucketed=False,
                             adam=AdamConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=4))
        return Trainer(build_model(ModelConfig(**TRAINER_MODEL)), edgc, tcfg,
                       seed=0, device="cpu")

    plain = trainer()
    hist = plain.run(SyntheticLM(**TRAINER_DATA).batches(),
                     num_steps=TRAINER_STEPS)
    plain.save_checkpoint(str(tmp / "plain"), step=TRAINER_STEPS)
    np.testing.assert_allclose(unit["trainer_loss"], [h["loss"] for h in hist],
                               rtol=0, atol=1e-4)
    a, b = (json.loads((tmp / f"{p}.json").read_text())
            for p in ("ckpt/tp", "plain"))
    assert a["names"] == b["names"]
    assert a["extra"]["step"] == b["extra"]["step"] == TRAINER_STEPS
    za, zb = np.load(tmp / "ckpt" / "tp.npz"), np.load(tmp / "plain.npz")
    for i, name in enumerate(a["names"]):
        x, y = za[f"leaf_{i}"], zb[f"leaf_{i}"]
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if ".q" in name:
            x, y = np.abs(x), np.abs(y)
        np.testing.assert_allclose(x, y, rtol=2e-3, atol=3e-4, err_msg=name)
    assert unit["restored_equal"]
    assert unit["restored_step"] == TRAINER_STEPS
    assert np.isfinite(unit["restored_loss"]).all()
    whole = trainer()
    assert whole.restore_checkpoint(str(tmp / "ckpt" / "tp")) == TRAINER_STEPS
    saved, _ = ckpt_mod.restore(str(tmp / "ckpt" / "tp"),
                                whole._checkpoint_like(gather=False))
    for x, y in zip(tree.leaves(whole.state), tree.leaves(
            dict(saved, comp={k: type(v)(*(t[0] for t in v))
                              for k, v in saved["comp"].items()}))):
        assert torch.equal(x, y)
    data = SyntheticLM(**TRAINER_DATA).batches()
    for _ in range(TRAINER_STEPS):
        next(data)
    more = whole.run(data, num_steps=1)
    np.testing.assert_allclose([h["loss"] for h in more],
                               unit["restored_loss"], rtol=0, atol=1e-4)


class _Mesh:
    """A stand-in (data, model) mesh: what a trainer or step reads before
    it refuses, with no process group."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data: int, model: int) -> None:
        self.shape = (data, model)

    def size(self, i: int) -> int:
        return self.shape[i]

    def get_group(self, name):
        return None


def test_trainer_refuses_a_coded_wire_above_model_size_one():
    from repro_torch.core import EDGCConfig
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    edgc = EDGCConfig(policy="fixed", fixed_rank=8, num_stages=2)
    for wire in ("quant8", "entropy"):
        with pytest.raises(ValueError,
                           match="requires the bucketed sync executor"):
            Trainer(build_model(ModelConfig(**CONFIGS["dense"])), edgc,
                    TrainerConfig(total_steps=1, wire=wire), seed=0,
                    device="cpu", mesh=_Mesh(1, 2))


def test_auto_mode_refuses_a_compressed_plan():
    from repro_torch.core.compressor import CompressionPlan
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.train.step import TrainStepConfig, make_train_step
    model = build_model(ModelConfig(**CONFIGS["dense"]))
    plan = CompressionPlan(ranks=(("['stages'][0]['blocks']['attn']['wq']",
                                   8),))
    with pytest.raises(NotImplementedError, match="must be 'none'"):
        make_train_step(model, TrainStepConfig(mode="auto", policy_plan=plan),
                        mesh=_Mesh(2, 2))
    with pytest.raises(ValueError, match="needs a"):
        make_train_step(model, TrainStepConfig(mode="auto"))


def test_launcher_model_mesh_on_cpu_processes(tmp_path):
    """``--model-mesh 2`` under ``torch.distributed.run``: two gloo
    processes train the tied GPT-2 reduction for 2 steps."""
    out = tmp_path / "run.json"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.train", "--arch", "gpt2", "--variant", "reduced",
         "--policy", "fixed", "--rank", "8", "--model-mesh", "2", "--steps",
         "2", "--batch", "4", "--seq", "16", "--device", "cpu", "--out",
         str(out)], env=_env(), cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    assert "mesh data=1 x model=2" in proc.stdout
    hist = json.loads(out.read_text())["history"]
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
