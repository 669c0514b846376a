"""Whisper parity: the port's ``models/encdec.py``, its ``EncDecAdapter``
(a boundary of two tensors, ``{"mem", "x"}``), the executor's pytree
boundary and the trainers against the reference's, on the reduced config
and ``tests/test_pipeline.py``'s ``FAMILY_CFGS`` (2 encoder + 2 decoder
layers: encoder | decoder at S = 2), with the reference's weights carried
across; and the one-tensor families' pipelined results, bit-equal through
the pytree path.

Bars: the layers at rtol 1e-5; the fp32 loss at rtol 1e-5 and gradients
at rtol 1e-4, atol 1e-6 (``test_torch_model.py``'s); trainer losses within
5e-3 (``tests/test_pipeline.py:553``'s) with equal bytes; the pipelined
pooled entropy within 1e-6 of the flat one (``tests/test_pipeline.py:611``'s);
``DistPipe`` within 1e-6 of ``LocalPipe`` (``test_torch_pipeline_dist.py``'s).
"""
import dataclasses
import json
import os
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
from repro.core import GDSConfig as RefGDSConfig
from repro.core.entropy import grads_entropy as ref_grads_entropy
from repro.models import encdec as ref_encdec
from repro.models import layers as ref_layers
from repro.pipeline import partition as ref_part

from _torch_families import (  # noqa: F401  (the autouse fixture)
    assert_close, batches, bf16_forward_matches, check_history, family_data,
    loss_and_grads_match, pair, port_config, port_trainer, ref_trainer,
    small_torch_thread_pool)
from test_pipeline import FAMILY_CFGS

from repro_torch import tree
from repro_torch.core import GDSConfig
from repro_torch.core.entropy import (entropy_from_moments, grads_entropy,
                                      sample_moments)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import from_reference, to_tensor
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models.model import ModelConfig
from repro_torch.pipeline import executor
from repro_torch.pipeline import partition as part_mod
from repro_torch.pipeline.adapters import (DenseAdapter, EncDecAdapter,
                                           TensorSpec, boundary_leaves,
                                           boundary_unflatten,
                                           supported_reason)
from repro_torch.pipeline.executor import LocalPipe, host_state
from repro_torch.train.step import TrainStepConfig, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper-base"


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("T,d", [(30, 128), (7, 6), (1500, 512)])
def test_sinusoidal_pos_matches_reference(T, d):
    """Within two ulps of the largest angle, T x 2^-23 each: the two
    libraries' fp32 ``exp`` of the frequencies may differ by an ulp, which
    at position 1499 moves the angle by about that much."""
    got = L.sinusoidal_pos(T, d)
    assert got.dtype == torch.float32
    assert_close(got, ref_layers.sinusoidal_pos(T, d), rtol=1e-5,
                 atol=max(1e-6, 2 * T * 2.0 ** -23))
    assert L.sinusoidal_pos(T, d, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("x_dtype,mem_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_cross_attention_matches_reference(x_dtype, mem_dtype):
    """Cross K/V from the encoder memory and cross-attention over them, in
    the dtypes the reference gives each product (the fp32 memory under
    bf16 weights: the attention in fp32, the output in x's dtype)."""
    rng = np.random.default_rng(4)
    p_np = jax.device_get(ref_layers.attn_init(
        jax.random.PRNGKey(2), 64, 4, 4, 16, getattr(jnp, x_dtype)))
    p = tree.tree_map(to_tensor, p_np)
    x_np = rng.standard_normal((2, 9, 64)).astype(np.float32)
    mem_np = rng.standard_normal((2, 13, 64)).astype(np.float32)
    x = torch.from_numpy(x_np).to(getattr(torch, x_dtype))
    mem = torch.from_numpy(mem_np).to(getattr(torch, mem_dtype))
    ek_r, ev_r = ref_layers.cross_kv(
        p_np, jnp.asarray(mem_np, getattr(jnp, mem_dtype)), num_kv_heads=4,
        head_dim=16)
    want = ref_layers.cross_attn_apply(
        p_np, jnp.asarray(x_np, getattr(jnp, x_dtype)), ek_r, ev_r,
        num_heads=4, num_kv_heads=4, head_dim=16)
    ek, ev = L.cross_kv(p, mem, num_kv_heads=4, head_dim=16)
    got = L.cross_attn_apply(p, x, ek, ev, num_heads=4, num_kv_heads=4,
                             head_dim=16)
    assert str(ek.dtype).split(".")[-1] == str(ek_r.dtype)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    tol = 1e-5 if x_dtype == mem_dtype == "float32" else 1e-2
    assert_close(ek, ek_r, rtol=tol, atol=tol)
    assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("S", [None, 1, 2, 3, 4, 5, 8, 13])
def test_stage_layout_matches_reference(S):
    for le in range(0, 7):
        for ld in range(1, 7):
            ref_cfg = dataclasses.replace(ref_get_config(ARCH, "reduced"),
                                          encoder_layers=le, num_layers=ld,
                                          num_stages=S or 2)
            assert encdec.stage_layout(port_config(ref_cfg), S) == \
                ref_encdec.stage_layout(ref_cfg, S), (le, ld, S)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_layout_matches_reference(S):
    """enc_blocks and dec_blocks under the stages of ``stage_layout``
    (encoder stages first), with the reference's paths, shapes, dtypes."""
    ref_cfg = dataclasses.replace(FAMILY_CFGS["whisper"], num_stages=S,
                                  dtype="bfloat16")
    cfg = port_config(ref_cfg)
    shapes = jax.eval_shape(lambda: ref_encdec.init(jax.random.PRNGKey(0),
                                                    ref_cfg))
    params = encdec.init(cfg, 0, "cpu")
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = tree.flatten_with_path(params)
    assert [jax.tree_util.keystr(kp) for kp, _ in want] == [p for p, _ in got]
    for (kp, w), (path, a) in zip(want, got):
        assert tuple(a.shape) == w.shape, path
        assert str(a.dtype).split(".")[-1] == str(w.dtype), path
    keys = [sorted(st) for st in params["stages"]]
    assert keys == [sorted(k for k, n in (("enc_blocks", c["enc"]),
                                          ("dec_blocks", c["dec"])) if n)
                    for c in encdec.stage_layout(cfg)]


@pytest.mark.parametrize("name", ["reduced", "family"])
def test_loss_and_grads_match_reference(name):
    ref_cfg = (ref_get_config(ARCH, "reduced") if name == "reduced"
               else FAMILY_CFGS["whisper"])
    ref_cfg, cfg, ref_model, model, params_np, params = pair(ref_cfg)
    ref_batch, batch = batches(cfg, seq=32)
    loss_and_grads_match(ref_model, model, params_np, params, ref_batch, batch)


def test_remat_gives_the_same_grads():
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        ref_get_config(ARCH, "reduced"))
    _, batch = batches(cfg, seq=16)
    out = []
    for remat in (False, True):
        m = encdec._build(dataclasses.replace(cfg, remat=remat))
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss, _ = m.loss_fn(tree.unflatten(params, leaves), batch)
        out.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_forward_keeps_the_encoder_stream_fp32():
    """Under bf16 weights the fp32 stub frames keep the encoder stream (and
    the memory the decoder reads) fp32 in both packages; the decoder
    stream is bf16; the logits are fp32, as close to the fp32 logits as the
    reference's."""
    _, _, params, batch, cfg = bf16_forward_matches(ARCH)
    ref_cfg = dataclasses.replace(ref_get_config(ARCH, "reduced"),
                                  dtype="bfloat16")
    params_np = jax.device_get(ref_encdec.init(jax.random.PRNGKey(3), ref_cfg))
    frames = jnp.asarray(batch["frames"].numpy())
    ref_mem = ref_encdec.encode(params_np, frames, ref_cfg)
    with torch.no_grad():
        mem = encdec.encode(params, batch["frames"], cfg)
        x = encdec.embed_tokens(params, batch["tokens"])
    assert str(ref_mem.dtype) == "float32" and mem.dtype == torch.float32
    assert x.dtype == torch.bfloat16


# ------------------------------------------------------------ stage adapter
@pytest.mark.parametrize("kw,S", [
    ({}, 2), (dict(num_stages=3), 2), (dict(num_stages=3), 3),
    (dict(num_stages=5), 5), (dict(num_layers=1, encoder_layers=3,
                                   num_stages=4), 4),
    (dict(num_stages=4), 4), (dict(num_stages=1), 1)])
def test_encdec_support_matches_reference(kw, S):
    ref_cfg = dataclasses.replace(FAMILY_CFGS["whisper"], **kw)
    assert supported_reason(port_config(ref_cfg), S) == \
        ref_part.pipeline_supported(ref_cfg, S)


@pytest.mark.parametrize("S", [2, 3])
def test_encdec_partition_merge_and_boundary(S):
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        FAMILY_CFGS["whisper"], num_stages=S)
    rp, part = (ref_part.make_partition(ref_model, S),
                part_mod.make_partition(model, S))
    assert isinstance(part, EncDecAdapter)
    assert part.unit_counts() == rp.unit_counts()
    assert part.num_units() == rp.num_units()
    ref_stage, ref_shared = rp.partition_params(params_np)
    stage, shared = part.partition_params(params)
    for a, b in zip(tree.leaves(stage), jax.tree_util.tree_leaves(ref_stage),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sorted(shared) == sorted(ref_shared)
    back = part.merge_params(stage, shared)
    for (pa, a), (pb, b) in zip(tree.flatten_with_path(back),
                                tree.flatten_with_path(params)):
        assert pa == pb and torch.equal(a, b)
    le = max(part.unit_counts()["enc_blocks"])
    assert [part.unit_index("dec_blocks", S - 1, i) for i in range(2)] == [
        le, le + 1]
    _, batch = batches(cfg, seq=8)
    spec = part.boundary_spec(batch)
    assert spec == {"mem": TensorSpec((2, 16, 128), torch.float32),
                    "x": TensorSpec((2, 8, 128), torch.float32)}
    bf16 = part_mod.make_partition(
        encdec._build(dataclasses.replace(cfg, dtype="bfloat16")), S)
    assert bf16.boundary_spec(batch) == {
        "mem": TensorSpec((2, 16, 128), torch.float32),
        "x": TensorSpec((2, 8, 128), torch.bfloat16)}


@pytest.mark.parametrize("S", [2, 3, 4])
def test_encdec_stagewise_forward_equals_flat_loss(S):
    """embed -> every stage's units one segment each -> head reproduces the
    flat loss: the encoder norm applied once, by the segment that runs the
    last encoder unit, and mem passed through the decoder stages."""
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        FAMILY_CFGS["whisper"], num_stages=S)
    part = part_mod.make_partition(model, S)
    ref_batch, batch = batches(cfg, seq=16)
    stage, shared = part.partition_params(params)
    with torch.no_grad():
        bnd = part.embed(shared, batch)
        assert sorted(bnd) == ["mem", "x"]
        for s in range(S):
            local = part.split_units(tree.tree_map(lambda a: a[s], stage))
            for u in range(part.num_units()):
                before = bnd
                bnd, aux = part.blocks_segment(local, shared, bnd, s, u,
                                               u + 1)
                assert float(aux) == 0.0
                if u >= max(part.unit_counts()["enc_blocks"]):
                    assert bnd["mem"] is before["mem"]   # passed through
        loss = part.head_loss(shared, bnd, batch)
        flat, _ = model.loss_fn(params, batch)
    ref_loss, _ = ref_model.loss_fn(params_np, ref_batch)
    np.testing.assert_allclose(float(loss), float(flat), rtol=2e-5)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)


def test_pipelined_entropy_matches_flat():
    """The enc | dec plan pads each stage's other half: pooling only the
    live units and the shared leaves once gives the flat entropy to 1e-6,
    and that is the reference's flat entropy of the same gradients."""
    ref_cfg = FAMILY_CFGS["whisper"]
    cfg = port_config(ref_cfg)
    model = encdec._build(cfg)
    params = model.init(0, "cpu")
    part = part_mod.make_partition(model, cfg.num_stages)
    rng = np.random.default_rng(0)
    grads_np = [rng.standard_normal(tuple(p.shape)).astype(np.float32)
                for p in tree.leaves(params)]
    grads = tree.unflatten(params, [torch.from_numpy(g) for g in grads_np])
    g_stage, g_shared = part.partition_params(grads)
    gds = GDSConfig(alpha=0.5, beta=0.25)
    z = torch.zeros(())
    n = s1 = s2 = z
    for s in range(cfg.num_stages):
        local = tree.tree_map(lambda a: a[s], g_stage)
        for key in sorted(local):
            kn, k1, k2 = sample_moments(local[key], gds,
                                        lead_mask=part.stage_flags(key, s))
            n, s1, s2 = n + kn, s1 + k1, s2 + k2
    n2, c1, c2 = sample_moments(g_shared, gds)
    pooled = float(entropy_from_moments(n + n2, s1 + c1, s2 + c2))
    flat = float(grads_entropy(grads, gds))
    assert abs(pooled - flat) < 1e-6, (pooled, flat)
    ref_params = jax.eval_shape(lambda: ref_encdec.init(jax.random.PRNGKey(0),
                                                        ref_cfg))
    ref_grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(ref_params), grads_np)
    ref_flat = float(ref_grads_entropy(ref_grads,
                                       RefGDSConfig(alpha=0.5, beta=0.25)))
    assert abs(flat - ref_flat) < 1e-6, (flat, ref_flat)


# ---------------------------------------------------------------- trainers
def test_flat_trainer_matches_reference():
    ref = ref_trainer(ref_get_config(ARCH, "reduced"))
    port = port_trainer(port_config(ref_get_config(ARCH, "reduced")))
    port.state = from_reference(jax.device_get(ref.state))
    want = ref.run(family_data(ref.model.config, reference=True))
    check_history(port.run(family_data(port.model.config)), want)


@pytest.mark.parametrize("name", ["reduced", "family"])
def test_pipe1_m2_matches_flat_trainer(name):
    ref_cfg = (ref_get_config(ARCH, "reduced") if name == "reduced"
               else FAMILY_CFGS["whisper"])
    cfg = port_config(ref_cfg, num_stages=1)
    flat = port_trainer(cfg).run(family_data(cfg))
    check_history(port_trainer(cfg, micro=2, pipe=1).run(family_data(cfg)),
                  flat)


@pytest.mark.parametrize("S,stash", [(2, "replay"), (2, "full"),
                                     (3, "replay"), (3, "full")])
def test_localpipe_matches_flat_trainer(S, stash):
    """encoder | decoder at S = 2, and at S = 3 (the encoder split: enc
    [1, 1], dec [2]), on LocalPipe with M = 2: the two-tensor boundary
    forward and its cotangents back."""
    cfg = port_config(FAMILY_CFGS["whisper"], num_stages=S)
    flat = port_trainer(cfg).run(family_data(cfg))
    piped = port_trainer(cfg, micro=2, pipe=S, stash=stash).run(
        family_data(cfg))
    check_history(piped, flat)


@pytest.mark.parametrize("S,stash", [(4, "full"), (4, "every_k"),
                                     (3, "full")])
def test_localpipe_padded_decoder_unit_matches_flat_trainer(S, stash):
    """Three decoder layers: the decoder stages hold [2, 1], so the last
    stage has a padded unit. Under a per-unit stash its last segment runs
    the head alone, which reads no mem; mem's cotangent there is zero, and
    mem's accumulates over the decoder stages on the way back."""
    cfg = port_config(FAMILY_CFGS["whisper"], num_layers=3, num_stages=S)
    assert [st["dec"] for st in encdec.stage_layout(cfg, S)][-2:] == [2, 1]
    flat = port_trainer(cfg).run(family_data(cfg))
    piped = port_trainer(cfg, micro=2, pipe=S, stash=stash).run(
        family_data(cfg))
    check_history(piped, flat)


# ---------------------------------------------------- DistPipe, two procs
PP_WHISPER = dict(name="pp-whisper", family="whisper", num_layers=2,
                  encoder_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
                  d_ff=256, vocab_size=512, audio_frames=16, max_position=512,
                  num_stages=2)

_DIST = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    from test_torch_encdec import _transport_run
    from repro_torch.pipeline.executor import DistPipe
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    mets, params = _transport_run(DistPipe(2))
    with open(f"{out}.{rank}", "w") as f:
        json.dump({"mets": mets, "params": params}, f)
    dist.destroy_process_group()
""")


def _transport_run(pipe, steps=2):
    """Two pipelined steps of pp-whisper at S = 2 (M = 2, full stash) on
    the stages ``pipe`` hosts, from the trainer's state."""
    cfg = ModelConfig(**PP_WHISPER)
    tr = port_trainer(cfg, micro=2, pipe=2, stash="full")
    scfg = TrainStepConfig(policy_plan=tr.controller.plan, gds=tr.edgc_cfg.gds,
                           pipeline=tr.pipeline_cfg, sync=tr.sync_cfg,
                           adam=tr.tcfg.adam, remat=False)
    step = make_train_step(tr.model, scfg, psum_mean=lambda x: x, pipe=pipe)
    state = host_state(tr.state, pipe.stages)
    data = family_data(cfg)
    mets = []
    for _ in range(steps):
        batch = {k: (torch.as_tensor(v) if v.dtype == np.float32
                     else torch.as_tensor(v).long())
                 for k, v in next(data).items()}
        state, m = step(state, batch)
        mets.append([float(m[k]) for k in ("loss", "entropy", "grad_norm",
                                           "ef_norm")]
                    + m["stage_entropy"].tolist())
    return mets, [p.tolist() for p in tree.leaves(state["stage_params"])]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_tensor_boundary_over_distpipe_equals_localpipe(tmp_path):
    """Each stage in its own gloo process (one message per boundary leaf,
    mem and x, each way) against both stages in one process."""
    mets, params = _transport_run(LocalPipe(2))
    out = tmp_path / "dist"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _DIST, str(r), str(port),
                               str(out), os.path.join(ROOT, "tests")],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    for r in range(2):
        got = json.loads((tmp_path / f"dist.{r}").read_text())
        np.testing.assert_allclose(got["mets"], mets, rtol=0, atol=1e-6)
        for a, b in zip(got["params"], params, strict=True):
            np.testing.assert_allclose(np.asarray(a)[0], np.asarray(b)[r],
                                       rtol=0, atol=1e-6)


def test_boundary_leaves_round_trip():
    t = torch.zeros(2)
    assert boundary_leaves(t) == [t]
    assert boundary_unflatten(t, [t + 1]).tolist() == [1.0, 1.0]
    b = {"x": torch.ones(1), "mem": torch.zeros(3)}
    assert [v.numel() for v in boundary_leaves(b)] == [3, 1]
    back = boundary_unflatten(b, [v * 2 for v in boundary_leaves(b)])
    assert sorted(back) == ["mem", "x"] and back["x"].tolist() == [2.0]


# ------------------------------------- one-tensor families, bit for bit
class _DictBoundary(DenseAdapter):
    """The dense adapter with its boundary wrapped in a one-key dict: the
    executor's pytree path, for the one-tensor path to be held to."""

    def boundary_spec(self, mb):
        return {"x": super().boundary_spec(mb)}

    def embed(self, shared, mb):
        return {"x": super().embed(shared, mb)}

    def blocks_segment(self, stage_tree, shared, bnd, s, lo, hi):
        y, aux = super().blocks_segment(stage_tree, shared, bnd["x"], s, lo,
                                        hi)
        return {"x": y}, aux

    def head_loss(self, shared, bnd, mb):
        return super().head_loss(shared, bnd["x"], mb)


@pytest.mark.parametrize("stash", ["replay", "full"])
def test_one_tensor_boundary_is_bit_equal_to_a_dict_of_one(stash,
                                                           monkeypatch):
    """The dense family's pipelined steps (S = 2, M = 2, ragged 3 layers)
    give bit-equal losses, metrics and weights through the one-tensor
    boundary and through a one-key dict of it."""
    cfg = ModelConfig(name="pp", family="dense", num_layers=3, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      num_stages=2)
    runs = []
    for wrap in (False, True):
        tr = port_trainer(cfg, micro=2, pipe=2, stash=stash)
        if wrap:
            monkeypatch.setattr(
                executor, "make_partition",
                lambda model, S, remat=None: _DictBoundary(model, S, remat))
        step = tr._get_step(True)
        state = tr.state
        data = SyntheticLM(256, 16, 4, seed=1).batches()
        mets = []
        for _ in range(2):
            batch = {k: torch.as_tensor(v).long()
                     for k, v in next(data).items()}
            state, m = step(state, batch)
            mets.append({k: v.clone() for k, v in m.items()})
        runs.append((mets, tree.leaves(state)))
    (m0, s0), (m1, s1) = runs
    for a, b in zip(m0, m1, strict=True):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(s0, s1, strict=True):
        assert torch.equal(a, b)


def test_launch_whisper_pipe2_on_cpu(capsys):
    """``--arch whisper-base --pipe 2`` on the CPU: the launcher attaches
    the stub frames and the pipelined trainer runs encoder | decoder."""
    from repro_torch.launch.train import main
    hist = main(["--arch", ARCH, "--variant", "reduced", "--policy", "fixed",
                 "--rank", "8", "--pipe", "2", "--micro", "2", "--steps", "2",
                 "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "whisper-smoke" in capsys.readouterr().out
