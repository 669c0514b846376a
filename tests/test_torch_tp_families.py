"""Tensor parallelism for the xLSTM, Mamba2/Zamba2, Whisper and VLM
families against the reference.

As ``tests/test_torch_tp.py`` does for the dense and MoE families: the
reference runs its ``dp_tp`` step on Auto-axis meshes of 8 fake CPU devices
in subprocesses, and the port runs the same step in gloo processes, one per
mesh device, from the same starting state on the same ``SyntheticLM``
batches (with the stub frames and patches the Whisper and VLM families
read), under AdamW at lr 1e-3. The port at 2x2 is held to the reference at
2x2; at data 1 and model > 1 the reference's ``dp_tp`` step does not
compile (ROADMAP Queue 3), so the port at 1x2 and 1x4 is held to its 1x1.
The bars are ``test_torch_tp.py``'s: losses and entropies 1e-4; EF and |Q|
at rtol 2e-3 / atol 3e-4; each parameter's change over the run within
1e-2 of the reference's, relative in norm.

The reduced configs split where the model axis divides them; at model 4
xlstm-smoke's two heads and zamba2-smoke's 548-wide ``in_proj`` do not,
so those two run at 1x2 and 2x2 only. The two-process world also checks the layers' local
paths against their unsplit results (the Mamba2 ``zxbcdt`` gather, the
mLSTM's recurrence on local heads) and that the sLSTM's loop over time
issues no DTensor op per token; each family's trainer runs two steps
through the launcher's ``--model-mesh 2`` under ``torch.distributed.run``.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_tp import ROOT, _env, _free_port, _wait

ARCHS = ("xlstm-125m", "zamba2-7b", "whisper-base", "phi-3-vision-4.2b")
STEPS, BATCH, SEQ = 2, 8, 32
ADAM = dict(lr=1e-3, warmup_steps=1, total_steps=4)
DELTA_BAR = 1e-2

# (arch, data, model): the reference's runs in three subprocesses at once
REF_RUNS = [[("xlstm-125m", 1, 1), ("xlstm-125m", 2, 2)],
            [("zamba2-7b", 1, 1), ("zamba2-7b", 2, 2), ("whisper-base", 1, 1)],
            [("whisper-base", 2, 2), ("phi-3-vision-4.2b", 1, 1),
             ("phi-3-vision-4.2b", 2, 2)]]
# 1x4 where the widths divide: xlstm-smoke's two heads and zamba2-smoke's
# 548-wide in_proj do not
PORT_RUNS = {2: [(a, 1, 2) for a in ARCHS],
             4: [(a, 2, 2) for a in ARCHS]
             + [(a, 1, 4) for a in ("whisper-base", "phi-3-vision-4.2b")]}


def _key(run) -> str:
    return "{}/{}x{}".format(*run)


_REF_STATE = textwrap.dedent("""
    import jax
    import numpy as np
    from repro.configs import get_config
    from repro.core import classify_leaves, make_plan
    from repro.core.compressor import init_compressor_state
    from repro.data.pipeline import SyntheticLM, add_modality_stubs
    from repro.models.model import build_model
    from repro.optim import adam
    from repro.train.step import replicate_comp_state

    def ref_state(arch, adam_kw):
        cfg = get_config(arch, "reduced")
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        plan = make_plan("fixed", classify_leaves(params, cfg.num_layers, 2,
                                                  min_dim=64), fixed_rank=8)
        ost = adam.init(params, adam.AdamConfig(**adam_kw))
        comp = replicate_comp_state(
            init_compressor_state(params, plan, jax.random.PRNGKey(1)), 2)
        return cfg, model, plan, {"params": params, "opt_m": ost.m,
                                  "opt_v": ost.v, "opt_step": ost.step,
                                  "comp": comp}

    def batches(cfg, seq, batch):
        for b in SyntheticLM(cfg.vocab_size, seq, batch, seed=0).batches():
            yield add_modality_stubs(b, cfg.family,
                                     audio_frames=cfg.audio_frames,
                                     num_patches=cfg.num_patches,
                                     d_model=cfg.d_model)
""")

_REF_SCRIPT = _REF_STATE + textwrap.dedent("""
    import pickle, sys
    import jax.numpy as jnp
    from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P
    from repro.train.step import (TrainStepConfig, batch_shardings,
                                  make_train_step, state_shardings)
    args = pickle.loads(bytes.fromhex(sys.argv[1]))
    out = {}
    for arch, d, m in args["runs"]:
        cfg, model, plan, state = ref_state(arch, args["adam"])
        devs = np.array(jax.devices()[:d * m]).reshape(d, m)
        mesh = Mesh(devs, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        scfg = TrainStepConfig(mode="dp_tp", policy_plan=plan, remat=False,
                               adam=adam.AdamConfig(**args["adam"]))
        step = make_train_step(model, mesh, scfg)
        state = dict(state, comp=jax.tree_util.tree_map(lambda a: a[:d],
                                                        state["comp"]))
        sshard = state_shardings(state, model, mesh)
        flat = lambda t: {jax.tree_util.keystr(kp): np.asarray(v) for kp, v
                          in jax.tree_util.tree_flatten_with_path(t)[0]}
        start = flat(state["params"])
        st = jax.device_put(state, sshard)
        data = batches(cfg, args["seq"], args["batch"])
        jstep, losses, ents = None, [], []
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
        params = flat(st["params"])
        out["{}/{}x{}".format(arch, d, m)] = {
            "loss": losses, "entropy": ents,
            "delta": {k: params[k] - start[k] for k in params},
            "comp": {k: (np.asarray(v.q)[0], np.asarray(v.err)[0])
                     for k, v in st["comp"].items()}}
    with open(args["out"], "wb") as f:
        pickle.dump(out, f)
    print("REF_TPF_OK")
""")

# Checks of the two-process world beside its runs: each layer's local path
# against its unsplit result, and DTensor's dispatches in the sLSTM.
_UNIT_CHECKS = textwrap.dedent("""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding, tp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ssm

    def _layer(fn, p, x, cfg, mesh):
        # the layer's output and its parameters' gradients, unsplit and on
        # the 1 x world mesh: the largest difference over the largest value
        def run(params, split):
            x_ = x.clone().requires_grad_(True)
            with tp.model_context(split):
                y = fn(params, x_, cfg)
                y = y.full_tensor() if split else y
                g = torch.autograd.grad((y * w).sum(), tree.leaves(params))
            return y, [tp.normalize_grad(a, b) for a, b in
                       zip(g, tree.leaves(params))]
        gen = torch.Generator().manual_seed(1)
        w = torch.randn(x.shape, generator=gen)
        plain = tree.tree_map(lambda a: a.detach().requires_grad_(True), p)
        specs = sharding.param_pspecs(p, mesh["model"])
        placed = tree.tree_map(lambda a: a.detach().requires_grad_(True),
                               sharding.distribute_tree(p, specs,
                                                        mesh["model"]))
        y0, g0 = run(plain, False)
        y1, g1 = run(placed, True)
        rel = lambda a, b: float(((a - b).abs().max() / b.abs().max()).detach())
        return {"out": rel(y1, y0),
                "grads": max(rel(a.full_tensor(), b) for a, b in zip(g1, g0)),
                "split": [str(a.placements) for a in tree.leaves(placed)]}

    class DTensorOps(TorchDispatchMode):
        # counts the ops dispatched with a DTensor operand (the mode sees
        # each op before DTensor does, and not the local ops it runs)
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(isinstance(a, DTensor) for a in tree_leaves((args, kwargs))):
                self.n += 1
            return func(*args, **kwargs)

    def unit_checks(rank, world, args):
        res = {}
        mesh = make_host_mesh(data=1, model=world, device_type="cpu")
        gen = torch.Generator().manual_seed(0)
        zamba = get_config("zamba2-7b", "reduced")
        p = tree.tree_map(lambda a: a[0], ssm.mamba2_init(gen, 1, zamba))
        x = torch.randn((2, 40, zamba.d_model), generator=gen)
        res["mamba2"] = _layer(ssm.mamba2_apply, p, x, zamba, mesh)
        xl = get_config("xlstm-125m", "reduced")
        p = tree.tree_map(lambda a: a[0], ssm.mlstm_init(gen, 1, xl))
        x = torch.randn((2, 40, xl.d_model), generator=gen)
        res["mlstm"] = _layer(ssm.mlstm_apply, p, x, xl, mesh)
        # the sLSTM's DTensor dispatches do not grow with T
        p = tree.tree_map(lambda a: a[0], ssm.slstm_init(gen, 1, xl))
        p = sharding.distribute_tree(
            p, sharding.param_pspecs(p, mesh["model"]), mesh["model"])
        p = tree.tree_map(lambda a: a.detach().requires_grad_(True), p)
        counts = {}
        for T in (16, 48):
            x = torch.randn((2, T, xl.d_model), generator=gen)
            with tp.model_context(), DTensorOps() as ops:
                y = ssm.slstm_apply(p, x, xl)
                torch.autograd.grad(y.full_tensor().sum(), tree.leaves(p))
            counts[T] = ops.n
        res["slstm_dispatches"] = counts
        return res
""")

_PORT_SCRIPT = _UNIT_CHECKS + textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import classify_leaves, make_plan
    from repro_torch.data.pipeline import SyntheticLM, add_modality_stubs
    from repro_torch.interop import from_reference
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
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
    for arch, d, m in args["runs"]:
        cfg = get_config(arch, "reduced")
        model = build_model(cfg)
        mesh = make_host_mesh(data=d, model=m, device_type="cpu")
        state = from_reference(init[arch], "cpu", mesh=mesh)
        plan = make_plan("fixed", classify_leaves(
            from_reference(init[arch])["params"], cfg.num_layers, 2,
            min_dim=64), fixed_rank=8)
        scfg = TrainStepConfig(mode="dp_tp", policy_plan=plan, bucketed=False,
                               remat=False, adam=AdamConfig(**args["adam"]))
        step = make_train_step(model, scfg, mesh=mesh)
        w, per = mesh.get_local_rank("data"), args["batch"] // d
        data = SyntheticLM(cfg.vocab_size, args["seq"], args["batch"],
                           seed=0).batches()
        start = {p: v.clone() for p, v in
                 tree.flatten_with_path(full_state(state)["params"])}
        losses, ents = [], []
        for _ in range(args["steps"]):
            raw = add_modality_stubs(next(data), cfg.family,
                                     audio_frames=cfg.audio_frames,
                                     num_patches=cfg.num_patches,
                                     d_model=cfg.d_model)
            batch = {k: torch.as_tensor(np.asarray(v)[w * per:(w + 1) * per])
                     for k, v in raw.items()}
            batch = {k: v if v.is_floating_point() else v.long()
                     for k, v in batch.items()}
            state, mets = step(state, batch)
            losses.append(float(mets["loss"]))
            ents.append(float(mets["entropy"]))
        full = full_state(state)
        if rank == 0:
            params = {p: v.numpy() for p, v in
                      tree.flatten_with_path(full["params"])}
            out["{}/{}x{}".format(arch, d, m)] = {
                "loss": losses, "entropy": ents,
                "delta": {p: v - start[p].numpy() for p, v in params.items()},
                "comp": {k: (v.q.numpy(), v.err.numpy())
                         for k, v in full["comp"].items()}}
    if args.get("unit"):
        out["unit"] = unit_checks(rank, world, args)
    if rank == 0:
        with open(args["out"], "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()
""")


def _start(script: str, argv: list[str], env=None) -> subprocess.Popen:
    """``python -c script *argv`` (``env``: test_torch_tp's by default)."""
    return subprocess.Popen([sys.executable, "-c", script, *argv],
                            env=env or _env(), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _launcher(arch: str, out: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.train", "--arch", arch, "--variant", "reduced",
         "--policy", "fixed", "--rank", "8", "--model-mesh", "2", "--steps",
         "2", "--batch", "4", "--seq", "16", "--device", "cpu", "--out",
         out], env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' results, keyed by run, and each family's launcher
    output; the reference subprocesses, the two port worlds and the four
    launchers run at once."""
    tmp = tmp_path_factory.mktemp("tpf")
    scope: dict = {}
    exec(_REF_STATE, scope)
    import jax
    init = {}
    for arch in ARCHS:
        _, _, _, state = scope["ref_state"](arch, ADAM)
        state = jax.device_get(state)
        state["comp"] = {k: (np.asarray(v.q), np.asarray(v.err))
                         for k, v in state["comp"].items()}
        init[arch] = state
    with open(tmp / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    common = dict(adam=ADAM, steps=STEPS, batch=BATCH, seq=SEQ,
                  init=str(tmp / "init.pkl"))
    ref_env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=8")
    refs = [_start(_REF_SCRIPT, [pickle.dumps(dict(
        common, runs=r, out=str(tmp / f"ref{i}.pkl"))).hex()], env=ref_env)
        for i, r in enumerate(REF_RUNS)]
    worlds = {}
    for w, r in PORT_RUNS.items():
        port = _free_port()
        blob = pickle.dumps(dict(common, runs=r, unit=(w == 2),
                                 out=str(tmp / f"port{w}.pkl"))).hex()
        worlds[w] = [_start(_PORT_SCRIPT, [str(k), str(w), str(port), blob])
                     for k in range(w)]
    launchers = {a: _launcher(a, str(tmp / f"{a}.json")) for a in ARCHS}
    for procs in worlds.values():
        _wait(procs, 600)
    cli = {a: _wait([p], 600) for a, p in launchers.items()}
    assert _wait(refs, 900).count("REF_TPF_OK") == len(REF_RUNS)
    ref, port = {}, {}
    for i in range(len(REF_RUNS)):
        with open(tmp / f"ref{i}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    for w in worlds:
        with open(tmp / f"port{w}.pkl", "rb") as f:
            port.update(pickle.load(f))
    hist = {a: json.loads((tmp / f"{a}.json").read_text())["history"]
            for a in ARCHS}
    return ref, port, cli, hist


ALL_PORT_RUNS = [r for rs in PORT_RUNS.values() for r in rs]


def _ref_key(run) -> str:
    """The reference run a port run is held to: the same mesh, or 1x1 at
    data 1 (the reference's dp_tp step does not compile there)."""
    arch, d, m = run
    return _key((arch, 1, 1)) if d == 1 else _key(run)


@pytest.mark.parametrize("run", ALL_PORT_RUNS, ids=_key)
def test_family_step_matches_reference(runs, run):
    ref, port, _, _ = runs
    want, got = ref[_ref_key(run)], port[_key(run)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["entropy"], want["entropy"], rtol=0,
                               atol=1e-4)
    assert sorted(got["delta"]) == sorted(want["delta"])
    for path, a in want["delta"].items():
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


@pytest.mark.parametrize("layer", ["mamba2", "mlstm"])
def test_local_paths_equal_unsplit_layer(runs, layer):
    """At 1x2 the Mamba2 layer (``zxbcdt`` gathered over ``model``, the
    mix run whole, ``y`` cut for the row-parallel ``out_proj``) and the
    mLSTM (its recurrence on local heads) give the unsplit layer's output
    and parameter gradients, and their projections are split."""
    unit = runs[1]["unit"][layer]
    assert unit["out"] < 1e-5 and unit["grads"] < 1e-5, unit
    assert any("Shard" in s for s in unit["split"]), unit["split"]


def test_slstm_loop_issues_no_dtensor_op_per_token(runs):
    """The sLSTM's loop over time runs on local tensors: its forward and
    backward dispatch as many DTensor ops at T = 48 as at T = 16."""
    counts = runs[1]["unit"]["slstm_dispatches"]
    assert counts[16] == counts[48] > 0, counts


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_model_mesh_two_trains_each_family(runs, arch):
    """``--model-mesh 2`` under ``torch.distributed.run``: two gloo
    processes train the family's reduced config for 2 steps."""
    _, _, cli, hist = runs
    assert "mesh data=1 x model=2" in cli[arch], cli[arch][-3000:]
    assert len(hist[arch]) == 2
    assert all(np.isfinite(h["loss"]) for h in hist[arch])
