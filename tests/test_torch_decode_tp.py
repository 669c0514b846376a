"""Decode under the ``model`` mesh axis (the dry run's decode lowering):
each family's ``decode_step`` with its parameters split over a (data 2,
model 2) gloo world of four processes, each decoding its data rank's batch
rows into a cache of its own rows and kv heads (``dryrun._local_cache``),
against the reference's ``decode_step`` (under ``jax.jit``, unsplit) on
the same weights (``from_reference``), tokens and, for Whisper, stub
frames. ``dp_tp`` configs place the parameters on the model sub-mesh;
``auto`` configs (llama3-405b, qwen3-moe-235b-a22b) FSDP + TP on the whole
mesh, their tokens split over ``data``. fp32 reduced configs; the logits
of every step at the decode tests' rtol 1e-4 (``tests/test_torch_decode.py``)
and twice their atol, 2e-6 of the largest logit: the model group's sums
add their own order to the port's (largest seen 1.56e-6, zamba2-7b, where
the port's unsplit decode is 1.22e-6 from the reference on these inputs;
every other family within 1.43e-6). The same decode without a mesh is
held to the split one too."""
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import encdec as ref_encdec

from _torch_families import assert_close, pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen2-0.5b", "qwen2.5-3b", "phi-3-vision-4.2b", "xlstm-125m",
         "zamba2-7b", "whisper-base", "llama3-405b", "qwen3-moe-235b-a22b"]
BATCH, STEPS, MAX_LEN = 4, 4, 8
ATOL = 2e-6                     # of the largest logit (see above)

_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import sharding_mode
    from repro_torch.dist import tp
    from repro_torch.interop import from_reference
    from repro_torch.launch import dryrun
    from repro_torch.models import encdec
    from repro_torch.models.model import build_model
    from repro_torch.train.step import _split_rows

    rank, port, out, inputs = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               sys.argv[4])
    with open(inputs, "rb") as f:
        cases, B, steps, max_len = pickle.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    w = mesh.get_local_rank(0)
    rows = slice(w * B // 2, (w + 1) * B // 2)
    results = {}
    for arch, (cfg, params_np, toks, frames) in cases.items():
        mode = sharding_mode(arch)
        model = build_model(cfg)
        params = from_reference({"params": params_np})["params"]
        toks = torch.from_numpy(toks).long()

        def cache_of(r):
            if cfg.family == "whisper":
                return encdec.init_cache(
                    cfg, len(range(B)[r]), max_len,
                    frames=torch.from_numpy(frames[r]), params=params,
                    device="cpu")
            return model.init_cache(len(range(B)[r]), max_len, device="cpu")

        cache, unsplit = cache_of(slice(None)), []
        for t in range(steps):
            logits, cache = model.decode_step(params, cache, toks[:, t])
            unsplit.append(logits[rows].numpy())
        placed = dryrun._place_params(params, mesh, mode)
        cache, got = dryrun._local_cache(cache_of(rows), mesh, B // 2), []
        for t in range(steps):
            tok = toks[rows, t]
            if mode == "auto":
                tok = _split_rows(tok, mesh)
            with tp.model_context(True):
                logits, cache = model.decode_step(placed, cache, tok)
            got.append(dryrun._gather_model(logits).numpy())
        results[arch] = (np.stack(unsplit), np.stack(got))
    with open(out, "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference_decode():
    """Each arch's inputs for the port and the reference's logits of every
    step, (steps, B, vocab)."""
    cases, want = {}, {}
    for arch in ARCHS:
        p = pair(ref_get_config(arch, "reduced"))
        ref_cfg, cfg, ref_model, _, params_np, _ = p
        rng = np.random.default_rng(5)
        toks = rng.integers(0, cfg.vocab_size, (BATCH, STEPS)).astype(np.int32)
        frames = None
        if cfg.family == "whisper":
            frames = (np.random.default_rng(1).standard_normal(
                (BATCH, cfg.audio_frames, cfg.d_model)) * 0.1).astype(
                    np.float32)
            cache = ref_encdec.init_cache(ref_cfg, BATCH, MAX_LEN,
                                          frames=jnp.asarray(frames),
                                          params=params_np)
        else:
            cache = ref_model.init_cache(BATCH, MAX_LEN)
        dec, steps = jax.jit(ref_model.decode_step), []
        for t in range(STEPS):
            logits, cache = dec(params_np, cache, jnp.asarray(toks[:, t]))
            steps.append(np.asarray(logits))
        cases[arch] = (cfg, jax.device_get(params_np), toks, frames)
        want[arch] = np.stack(steps)
    return cases, want


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    """(the reference's logits by arch, each rank's (unsplit, split)
    logits of its rows by arch)."""
    tmp = tmp_path_factory.mktemp("decode_tp")
    cases, want = _reference_decode()
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump((cases, BATCH, STEPS, MAX_LEN), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SCRIPT, str(r), port, str(tmp / f"{r}.pkl"),
         str(inputs)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    out = []
    for r in range(4):
        with open(tmp / f"{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return want, out


def _rows(rank: int) -> slice:
    w = rank // 2                  # rank = data * 2 + model
    return slice(w * BATCH // 2, (w + 1) * BATCH // 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_a_model_mesh_matches_reference(decoded, arch):
    want, ranks = decoded
    for r, rank_results in enumerate(ranks):
        _, got = rank_results[arch]
        ref = want[arch][:, _rows(r)]
        for t in range(STEPS):
            assert_close(torch.from_numpy(got[t]), ref[t], atol=ATOL,
                         msg=f"{arch} rank {r} logits at step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_a_model_mesh_equals_unsplit(decoded, arch):
    for rank_results in decoded[1]:
        want, got = rank_results[arch]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))
