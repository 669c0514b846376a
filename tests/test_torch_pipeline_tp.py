"""The pipelined trainer on a mesh with a ``model`` axis against the
reference.

The reference's ``Trainer`` runs its pipelined step on an Auto-axis
``(pipe, data, model)`` mesh of fake CPU devices in subprocesses (at
most three at once) and writes its starting and final checkpoints. The
port restores the starting checkpoint into ``Trainer(..., pipe=2,
mesh=)`` in gloo processes, one per mesh device (``DistPipe`` over the
pipe group, the parameters as DTensors on the model group), runs the same
two steps on the same batches and writes its final checkpoint, which
gathers the reference's whole layout. Held at ``tests/test_torch_tp.py``'s
bars: losses 1e-4; ``bytes_synced``, ``bytes_full`` and ``stage_bytes``
equal; every live compressor slice at rtol 2e-3 / atol 3e-4 (|Q| up to
column sign), and every parameter and moment leaf's change over the run
within 1e-2 of the reference's, relative in norm. A live slice is a
stage's slice of its own schedule's state: each stage runs only its own
(ROADMAP Queue 3, slice 5), so where the stages' plans differ (Whisper's
encoder and decoder) the other slices keep their initial values in the
port.

The runs: every family's reduced config at S = 2 on a ``(2, 1, 2)`` mesh
(the tied gpt2, the MoE, the VLM, Whisper's two-tensor boundary, Zamba2's
ragged groups and an xLSTM with two (mLSTM, sLSTM) pairs, since one pair
cannot make two stages), gpt2 on ``(2, 2, 2)``, and gpt2 with both stages
in one process (``LocalPipe``) on a ``(data 1, model 2)`` mesh, held to
the reference's ``(2, 1, 2)`` run. The checkpoint the ``(2, 1, 2)`` gpt2
run writes is restored by a ``(2, 1, 1)`` world, which steps on: a
checkpoint holds one compressor replica per data-parallel worker, so in
both packages it restores on a mesh of the same data size, whatever its
model size.
"""
import json
import pickle
import re
import textwrap

import numpy as np
import pytest

from test_torch_tp import _env, _free_port, _wait
from test_torch_tp_families import _start

FAMILIES = ("gpt2", "qwen3-moe-235b-a22b", "phi-3-vision-4.2b",
            "whisper-base", "zamba2-7b", "xlstm-125m")
# config fields beside num_stages = 2
EXTRA = {"xlstm-125m": dict(num_layers=4)}
STEPS = 2
# (arch, pipe, data, model): the reference's runs, three subprocesses
REF_RUNS = [[("gpt2", 2, 1, 2), ("gpt2", 2, 2, 2),
             ("qwen3-moe-235b-a22b", 2, 1, 2)],
            [("xlstm-125m", 2, 1, 2), ("phi-3-vision-4.2b", 2, 1, 2)],
            [("whisper-base", 2, 1, 2), ("zamba2-7b", 2, 1, 2)]]
# (arch, pipe, data, model, local): the port's worlds by size; ``local``
# keeps both stages in each process (LocalPipe) on a (data, model) mesh
PORT_RUNS = {4: [(a, 2, 1, 2, False) for a in FAMILIES],
             8: [("gpt2", 2, 2, 2, False)],
             2: [("gpt2", 2, 1, 2, True)]}


def _key(run) -> str:
    arch, s, d, m = run[:4]
    local = len(run) > 4 and run[4]
    return f"{arch}/{'local ' if local else ''}{s}x{d}x{m}"


# Both packages' configs, trainers and batches, by package name.
_COMMON = textwrap.dedent("""
    import dataclasses, json, os, pickle, sys
    import numpy as np

    def setup(pkg, arch, S, extra):
        cfgs = __import__(pkg + ".configs", fromlist=["get_config"])
        core = __import__(pkg + ".core", fromlist=["EDGCConfig"])
        data = __import__(pkg + ".data.pipeline", fromlist=["SyntheticLM"])
        adam = __import__(pkg + ".optim.adam", fromlist=["AdamConfig"])
        tr = __import__(pkg + ".train.trainer", fromlist=["TrainerConfig"])
        cfg = dataclasses.replace(cfgs.get_config(arch, "reduced"),
                                  num_stages=S, **extra.get(arch, {}))
        edgc = core.EDGCConfig(policy="fixed", fixed_rank=8, num_stages=S,
                               total_iterations=4,
                               gds=core.GDSConfig(alpha=1.0, beta=0.25))
        tcfg = tr.TrainerConfig(total_steps=4, log_every=1,
                                num_microbatches=2,
                                adam=adam.AdamConfig(lr=1e-3, warmup_steps=1,
                                                     total_steps=4))

        def batches():
            for b in data.SyntheticLM(cfg.vocab_size, 32, 8,
                                      seed=3).batches():
                yield data.add_modality_stubs(
                    b, cfg.family, audio_frames=cfg.audio_frames,
                    num_patches=cfg.num_patches, d_model=cfg.d_model)
        return cfg, edgc, tcfg, batches

    def record(hist):
        return {k: [h[k] for h in hist] for k in
                ("loss", "bytes_synced", "bytes_full", "stage_bytes")}
""")

_REF_SCRIPT = _COMMON + textwrap.dedent("""
    import jax
    from jax.sharding import AxisType, Mesh
    from repro.models.model import build_model
    from repro.train.trainer import Trainer
    args = pickle.loads(bytes.fromhex(sys.argv[1]))
    for arch, S, D, M in args["runs"]:
        cfg, edgc, tcfg, batches = setup("repro", arch, S, args["extra"])
        devs = np.array(jax.devices()[:S * D * M]).reshape(S, D, M)
        mesh = Mesh(devs, ("pipe", "data", "model"),
                    axis_types=(AxisType.Auto,) * 3)
        tr = Trainer(build_model(cfg), mesh, edgc, tcfg, seed=0)
        out = os.path.join(args["out"], f"{arch}_{S}x{D}x{M}")
        tr.save_checkpoint(out + "_start", step=0)
        hist = tr.run(batches(), num_steps=args["steps"])
        tr.save_checkpoint(out + "_end", step=args["steps"])
        with open(out + ".json", "w") as f:
            json.dump(record(hist), f)
    print("REF_PP_OK")
""")

_PORT_SCRIPT = _COMMON + textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train.trainer import Trainer
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    args = pickle.loads(bytes.fromhex(sys.argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)

    def trainer(arch, S, D, M, local):
        cfg, edgc, tcfg, batches = setup("repro_torch", arch, S,
                                         args["extra"])
        mesh = (make_host_mesh(data=D, model=M, device_type="cpu") if local
                else make_host_mesh(pipe=S, data=D, model=M,
                                    device_type="cpu"))
        return Trainer(build_model(cfg), edgc, tcfg, seed=0, device="cpu",
                       pipe=S, mesh=mesh), batches

    out = {}
    for arch, S, D, M, local in args["runs"]:
        tr, batches = trainer(arch, S, D, M, local)
        ref = os.path.join(args["ref"], f"{arch}_{S}x{D}x{M}")
        tr.restore_checkpoint(ref + "_start")
        hist = tr.run(batches(), num_steps=args["steps"])
        tag = f"{arch}_{'local_' if local else ''}{S}x{D}x{M}"
        tr.save_checkpoint(os.path.join(args["out"], tag + "_end"),
                           step=args["steps"])
        out[tag] = dict(record(hist),
                        d_of_stage=list(tr._splans.d_of_stage))
    if args.get("restore"):
        # the (2, 1, 2) checkpoint restored on another mesh
        arch, S, D, M = args["restore"]
        tr, batches = trainer(arch, S, D, M, False)
        path = os.path.join(args["out"], f"{arch}_{S}x1x2_end")
        step = tr.restore_checkpoint(path)
        saved, _ = ckpt_mod.restore(path, tr._checkpoint_like(gather=False))
        whole = tr._checkpoint_like(gather=True)
        equal = all(torch.equal(a, b) for a, b in
                    zip(tree.leaves(whole), tree.leaves(saved)))
        data = batches()
        for _ in range(args["steps"]):
            next(data)
        more = tr.run(data, num_steps=1)
        out["restore"] = {"step": step, "equal": equal,
                          "loss": [h["loss"] for h in more]}
    if rank == 0:
        name = args.get("name") or f"port{world}"
        with open(os.path.join(args["out"], name + ".json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
""")


def _load(path: str) -> dict:
    """A checkpoint's leaves by name (the reference's and the port's
    ``.npz`` + ``.json`` pairs have one layout)."""
    names = json.loads(open(path + ".json").read())["names"]
    z = np.load(path + ".npz")
    return {n: np.asarray(z[f"leaf_{i}"]) for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs, then the port's three worlds at once."""
    tmp = tmp_path_factory.mktemp("pptp")
    ref_dir, port_dir = tmp / "ref", tmp / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    ref_env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=8")
    refs = [_start(_REF_SCRIPT, [pickle.dumps(dict(
        runs=r, extra=EXTRA, steps=STEPS, out=str(ref_dir))).hex()],
        env=ref_env) for r in REF_RUNS]
    assert _wait(refs, 900).count("REF_PP_OK") == len(REF_RUNS)
    def world(w, **kw):
        port = _free_port()
        blob = pickle.dumps(dict(extra=EXTRA, steps=STEPS, ref=str(ref_dir),
                                 out=str(port_dir), **kw)).hex()
        return [_start(_PORT_SCRIPT, [str(k), str(w), str(port), blob])
                for k in range(w)]
    worlds = {w: world(w, runs=r) for w, r in PORT_RUNS.items()}
    port = {}
    for w in (4, 2, 8):
        _wait(worlds[w], 600)
        port.update(json.loads((port_dir / f"port{w}.json").read_text()))
        if w == 4:
            # the (2, 1, 2) world wrote its checkpoint: restore it while the
            # (2, 2, 2) world runs on
            worlds[1] = world(2, runs=[], restore=("gpt2", 2, 1, 1),
                              name="restore")
    _wait(worlds[1], 300)
    port.update(json.loads((port_dir / "restore.json").read_text()))
    return ref_dir, port_dir, port


ALL_PORT_RUNS = [r for rs in PORT_RUNS.values() for r in rs]


@pytest.mark.parametrize("run", ALL_PORT_RUNS, ids=_key)
def test_pipelined_model_axis_matches_reference(runs, run):
    ref_dir, port_dir, port = runs
    arch, S, D, M, local = run
    ref_tag = f"{arch}_{S}x{D}x{M}"
    tag = f"{arch}_{'local_' if local else ''}{S}x{D}x{M}"
    want = json.loads((ref_dir / f"{ref_tag}.json").read_text())
    got = port[tag]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-4)
    for key in ("bytes_synced", "bytes_full", "stage_bytes"):
        assert got[key] == want[key], key
    start = _load(str(ref_dir / f"{ref_tag}_start"))
    ref_end = _load(str(ref_dir / f"{ref_tag}_end"))
    end = _load(str(port_dir / f"{tag}_end"))
    assert sorted(end) == sorted(ref_end)
    for name, b in ref_end.items():
        a = end[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name.startswith("['comp']"):
            if name.endswith(".q"):
                a, b = np.abs(a), np.abs(b)
            d = int(re.match(r"\['comp'\]\['p(\d+):", name).group(1))
            live = [s for s, ds in enumerate(got["d_of_stage"]) if ds == d]
            assert live, name
            np.testing.assert_allclose(a[live].astype(np.float64), b[live],
                                       rtol=2e-3, atol=3e-4, err_msg=name)
        elif a.dtype.kind == "f":
            d_ref = b.astype(np.float64) - start[name]
            d_port = a.astype(np.float64) - start[name]
            if not np.linalg.norm(d_ref):
                # a leaf the run leaves alone (a padded unit's slot)
                np.testing.assert_array_equal(a, b, err_msg=name)
                continue
            rel = np.linalg.norm(d_port - d_ref) / np.linalg.norm(d_ref)
            assert rel < 1e-2, (name, rel)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_pipelined_checkpoint_restores_on_another_mesh(runs):
    """The (2, 1, 2) gpt2 run's checkpoint has the reference's layout
    (whole leaves, (S, W, ...) compressor state); a (2, 1, 1) world (one
    stage a process, no model split) restores it bit for bit at its step
    and steps on."""
    ref_dir, port_dir, port = runs
    saved = _load(str(port_dir / "gpt2_2x1x2_end"))
    ref = _load(str(ref_dir / "gpt2_2x1x2_end"))
    assert {k: v.shape for k, v in saved.items()} == \
        {k: v.shape for k, v in ref.items()}
    got = port["restore"]
    assert got["step"] == STEPS and got["equal"]
    assert len(got["loss"]) == 1 and np.isfinite(got["loss"]).all()
