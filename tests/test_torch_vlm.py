"""VLM parity: the port's ``models/vlm.py``, its stage adapter, its
trainers and the modality stubs against the reference's, on the reduced
phi-3-vision config, with the reference's weights carried across by
``from_reference``; and the mixed-dtype products (``layers._mm``) the VLM
path needs.

Bars: the stub patches bit for bit; in fp32 the loss at rtol 1e-5 and
every gradient at rtol 1e-4, atol 1e-6 (``test_torch_model.py``'s); in
bf16 the logits within 1e-2 relative (the bf16 bar of the flash kernels'
tests) and in the reference's dtype; trainer losses within 5e-3
(``test_torch_trainer.py``'s bar) with ``bytes_synced`` equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs import get_config as ref_get_config
from repro.core import EDGCConfig as RefEDGCConfig
from repro.core import GDSConfig as RefGDSConfig
from repro.core.dac import DACConfig as RefDACConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.data.pipeline import add_modality_stubs as ref_add_modality_stubs
from repro.models import vlm as ref_vlm
from repro.models.model import build_model as ref_build_model
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.pipeline import partition as ref_part
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import EDGCConfig, GDSConfig
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM, add_modality_stubs
from repro_torch.interop import from_reference
from repro_torch.models import layers as L
from repro_torch.models import vlm
from repro_torch.models.model import build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.pipeline import partition as part_mod
from repro_torch.pipeline.adapters import VLMAdapter, supported_reason
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "phi-3-vision-4.2b"
STEPS = 3
DATA = dict(seq_len=32, batch_size=4, seed=3)


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _pair(dtype="float32", num_stages=None):
    ref_cfg, cfg = ref_get_config(ARCH, "reduced"), get_config(ARCH, "reduced")
    port_fields, ref_fields = dataclasses.asdict(cfg), dataclasses.asdict(ref_cfg)
    for name in port_fields.keys() & ref_fields.keys():
        assert port_fields[name] == ref_fields[name], name
    stages = num_stages or cfg.num_stages
    ref_cfg = dataclasses.replace(ref_cfg, dtype=dtype, num_stages=stages)
    cfg = dataclasses.replace(cfg, dtype=dtype, num_stages=stages)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    params_np = jax.device_get(ref_model.init(jax.random.PRNGKey(3)))
    params = from_reference({"params": params_np})["params"]
    return ref_cfg, cfg, ref_model, model, params_np, params


def _batches(cfg, seq=24):
    """One batch with stub patches, as numpy, from both packages' helpers
    (which must agree bit for bit)."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, seq + 1)).astype(np.int32)
    base = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    kw = dict(num_patches=cfg.num_patches, d_model=cfg.d_model, seed=7)
    got = add_modality_stubs(base, "vlm", **kw)
    want = ref_add_modality_stubs(base, "vlm", **kw)
    np.testing.assert_array_equal(got["patches"], want["patches"])
    ref_batch = {k: jnp.asarray(v) for k, v in want.items()}
    batch = {k: (torch.from_numpy(v) if v.dtype == np.float32
                 else torch.from_numpy(v).long()) for k, v in got.items()}
    return ref_batch, batch


@pytest.mark.parametrize("family,seed", [("vlm", 0), ("vlm", 11),
                                         ("whisper", 3), ("dense", 0)])
def test_modality_stubs_bit_equal(family, seed):
    base = {"tokens": np.zeros((3, 8), np.int32),
            "labels": np.zeros((3, 8), np.int32)}
    kw = dict(audio_frames=10, num_patches=16, d_model=32, seed=seed)
    got = add_modality_stubs(base, family, **kw)
    want = ref_add_modality_stubs(base, family, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    if family != "dense":
        assert got is not base and sorted(base) == ["labels", "tokens"]


def test_loss_and_grads_match_reference():
    ref_cfg, cfg, ref_model, model, params_np, params = _pair()
    assert sorted(params["projector"]) == ["b", "w"]
    ref_batch, batch = _batches(cfg)
    (ref_loss, _), ref_grads = jax.value_and_grad(
        ref_model.loss_fn, has_aux=True)(params_np, ref_batch)
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    loss, mets = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert mets["loss"] is loss
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(ref_flat) == len(grads)
    for (kp, want), got, (path, _) in zip(ref_flat, grads,
                                          tree.flatten_with_path(params)):
        assert jax.tree_util.keystr(kp) == path
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=path)


def test_bf16_forward_follows_reference_dtypes():
    """Under bf16 weights the fp32 stub patches promote the residual stream
    to fp32 in both packages: the embed and the logits are fp32, and the
    logits agree within the bf16 bar."""
    ref_cfg, cfg, ref_model, model, params_np, params = _pair("bfloat16")
    assert params["projector"]["w"].dtype == torch.bfloat16
    ref_batch, batch = _batches(cfg)
    ref_embed = ref_vlm._embed_multimodal(params_np, ref_batch["patches"],
                                          ref_batch["tokens"], ref_cfg)
    want = np.asarray(ref_model.forward(params_np, ref_batch))
    with torch.no_grad():
        embed = vlm._embed_multimodal(params, batch["patches"],
                                      batch["tokens"], cfg)
        got = model.forward(params, batch)
    assert str(ref_embed.dtype) == "float32" and embed.dtype == torch.float32
    assert tuple(embed.shape) == ref_embed.shape == (2, 16 + 24, 256)
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    assert got.shape == want.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(embed.numpy(), np.asarray(ref_embed), rtol=1e-2,
                               atol=1e-2 * float(np.abs(ref_embed).max()))
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert err < 1e-2, err


def _old_mm(eq, x, w):
    """``layers._mm`` before mixed operands were promoted."""
    return torch.einsum(eq, x, w).to(torch.float32)


@pytest.mark.parametrize("arch", ["gpt2", "qwen2-0.5b", "qwen3-32b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mm_promotion_leaves_same_dtype_models_bit_equal(arch, dtype,
                                                         monkeypatch):
    """A model whose operands share one dtype gives the same loss and
    gradients, bit for bit, through the promoting ``_mm`` and the old one."""
    cfg = dataclasses.replace(get_config(arch, "reduced"), dtype=dtype)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in
             next(SyntheticLM(cfg.vocab_size, 16, 2, seed=1).batches()).items()}
    out = []
    for mm in (L._mm, _old_mm):
        monkeypatch.setattr(L, "_mm", mm)
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss, _ = model.loss_fn(tree.unflatten(params, leaves), batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_mm_promotes_mixed_operands():
    x = torch.randn(2, 3, 8)
    w = torch.randn(8, 5).to(torch.bfloat16)
    got = L._mm("btd,de->bte", x, w)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.einsum("btd,de->bte", x, w.float()),
                               rtol=0, atol=0)


# ------------------------------------------------------------ stage adapter
def test_vlm_partition_merge_and_boundary():
    ref_cfg, cfg, ref_model, model, params_np, params = _pair(num_stages=2)
    rp, part = ref_part.make_partition(ref_model, 2), part_mod.make_partition(model, 2)
    assert isinstance(part, VLMAdapter)
    assert supported_reason(cfg, 2) == ref_part.pipeline_supported(ref_cfg, 2)
    assert part.unit_counts() == rp.unit_counts()
    ref_stage, ref_shared = rp.partition_params(params_np)
    stage, shared = part.partition_params(params)
    for a, b in zip(tree.leaves(stage), jax.tree_util.tree_leaves(ref_stage)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sorted(shared) == sorted(ref_shared)
    assert "projector" in shared
    back = part.merge_params(stage, shared)
    for (pa, a), (pb, b) in zip(tree.flatten_with_path(back),
                                tree.flatten_with_path(params)):
        assert pa == pb and torch.equal(a, b)
    _, batch = _batches(cfg, seq=8)
    spec = part.boundary_spec(batch)
    assert spec.shape == (2, 16 + 8, 256) and spec.dtype == torch.float32
    bf16 = part_mod.make_partition(
        build_model(dataclasses.replace(cfg, dtype="bfloat16")), 2)
    assert bf16.boundary_spec(batch).dtype == torch.float32


def test_vlm_stagewise_forward_equals_flat_loss():
    ref_cfg, cfg, ref_model, model, params_np, params = _pair(num_stages=2)
    part = part_mod.make_partition(model, 2)
    ref_batch, batch = _batches(cfg, seq=16)
    stage, shared = part.partition_params(params)
    with torch.no_grad():
        x = part.embed(shared, batch)
        assert tuple(x.shape) == part.boundary_spec(batch).shape
        for s in range(2):
            local = part.split_units(tree.tree_map(lambda a: a[s], stage))
            x, aux = part.blocks_segment(local, shared, x, s, 0,
                                         part.num_units())
            assert float(aux) == 0.0
        loss = part.head_loss(shared, x, batch)
        flat, _ = model.loss_fn(params, batch)
    ref_loss, _ = ref_model.loss_fn(params_np, ref_batch)
    np.testing.assert_allclose(float(loss), float(flat), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------- trainers
def _ref_mesh(pipe):
    shape, axes = ((1, 1, 1), ("pipe", "data", "model")) if pipe else \
        ((1, 1), ("data", "model"))
    devs = np.array(jax.devices()[:1]).reshape(shape)
    return Mesh(devs, axes, axis_types=(AxisType.Auto,) * len(axes))


def _tkw(micro):
    return dict(total_steps=STEPS, log_every=1, num_microbatches=micro,
                schedule="1f1b", stash_policy="replay")


def _ref_trainer(num_stages, micro=0, pipe=False):
    cfg = dataclasses.replace(ref_get_config(ARCH, "reduced"),
                              num_stages=num_stages)
    edgc = RefEDGCConfig(policy="fixed", fixed_rank=8, num_stages=num_stages,
                         total_iterations=STEPS,
                         gds=RefGDSConfig(alpha=0.5, beta=0.25),
                         dac=RefDACConfig(window=2, adjust_limit=4))
    tcfg = RefTrainerConfig(adam=RefAdamConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=STEPS),
                            **_tkw(micro))
    return RefTrainer(ref_build_model(cfg), _ref_mesh(pipe), edgc, tcfg, seed=0)


def _port_trainer(num_stages, micro=0, pipe=None):
    cfg = dataclasses.replace(get_config(ARCH, "reduced"),
                              num_stages=num_stages)
    edgc = EDGCConfig(policy="fixed", fixed_rank=8, num_stages=num_stages,
                      total_iterations=STEPS,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=2, adjust_limit=4))
    tcfg = TrainerConfig(adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=STEPS), **_tkw(micro))
    return Trainer(build_model(cfg), edgc, tcfg, seed=0, device="cpu",
                   pipe=pipe)


def _family_data(stubs, data_cls):
    cfg = get_config(ARCH, "reduced")
    for b in data_cls(cfg.vocab_size, **DATA).batches():
        yield stubs(b, "vlm", num_patches=cfg.num_patches,
                    d_model=cfg.d_model, seed=3)


def _check(got, want, bar=5e-3):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for a, b in zip(got, want, strict=True):
        assert np.isfinite(a["loss"]) and abs(a["loss"] - b["loss"]) < bar, (a, b)
        assert a["bytes_synced"] == b["bytes_synced"]
        assert a["bytes_full"] == b["bytes_full"]


@pytest.mark.parametrize("micro", [0, 1, 2], ids=["flat", "pipe1-m1",
                                                  "pipe1-m2"])
def test_trainer_matches_reference(micro):
    """The flat trainer, and pipe = 1 at M = 1 and 2, from the reference's
    state on the same stub-carrying batches."""
    pipe = micro > 0
    ref = _ref_trainer(1, micro, pipe=pipe)
    port = _port_trainer(1, micro, pipe=1 if pipe else None)
    port.state = from_reference(jax.device_get(ref.state))
    want = ref.run(_family_data(ref_add_modality_stubs, RefSyntheticLM))
    got = port.run(_family_data(add_modality_stubs, SyntheticLM))
    _check(got, want)


def test_localpipe_s2_matches_flat_trainer():
    """S = 2 on ``LocalPipe`` (M = 2) against the port's flat trainer on
    the same weights and batches: the microbatch split only reorders sums."""
    flat = _port_trainer(2).run(_family_data(add_modality_stubs, SyntheticLM))
    piped = _port_trainer(2, micro=2, pipe=2).run(
        _family_data(add_modality_stubs, SyntheticLM))
    _check(piped, flat)


def test_launch_pipe2_on_cpu(capsys):
    """``--arch phi-3-vision-4.2b --pipe 2`` on the CPU: the launcher
    attaches the stub patches and the pipelined trainer runs."""
    from repro_torch.launch.train import main
    hist = main(["--arch", ARCH, "--variant", "reduced", "--policy", "fixed",
                 "--rank", "8", "--pipe", "2", "--micro", "2", "--steps", "3",
                 "--batch", "4", "--seq", "16", "--device", "cpu"])
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert "phi3v-smoke" in capsys.readouterr().out
