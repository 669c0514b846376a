"""Shared harness of the recurrent and encoder-decoder family parity tests
(``test_torch_ssm.py``, ``test_torch_hybrid.py``, ``test_torch_encdec.py``):
config pairs, the reference's weights carried across, stub-carrying
batches, gradient comparison and both packages' trainers on the reduced
configs (the reference's on a hand-built Auto-axis mesh, since
``jax.make_mesh`` builds Explicit axes under jax 0.9)."""
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
from repro.models.model import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch import tree
from repro_torch.core import EDGCConfig, GDSConfig
from repro_torch.core.dac import DACConfig
from repro_torch.data.pipeline import SyntheticLM, add_modality_stubs
from repro_torch.interop import from_reference, to_tensor
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

STEPS = 3
RTOL, ATOL = 1e-4, 1e-6          # test_torch_model.py's gradient bar
TRAINER_BAR = 5e-3               # test_pipeline.py:553's loss bar


@pytest.fixture(autouse=True)
def small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def port_config(ref_cfg: RefModelConfig, **kw) -> ModelConfig:
    """The port's ModelConfig with the reference config's fields."""
    return ModelConfig(**dataclasses.replace(ref_cfg, **kw).__dict__)


def pair(ref_cfg: RefModelConfig, seed: int = 3, **kw):
    """(ref_cfg, cfg, ref_model, model, params_np, params): both models on
    the reference's weights."""
    ref_cfg = dataclasses.replace(ref_cfg, **kw)
    cfg = port_config(ref_cfg)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    params_np = jax.device_get(ref_model.init(jax.random.PRNGKey(seed)))
    params = from_reference({"params": params_np})["params"]
    return ref_cfg, cfg, ref_model, model, params_np, params


def batches(cfg, seq: int = 24, batch: int = 2, seed: int = 5):
    """(reference batch, port batch): tokens from both SyntheticLMs and the
    stub frames from both packages' helpers (checked equal)."""
    raw = next(RefSyntheticLM(cfg.vocab_size, seq, batch, seed=seed).batches())
    mine = next(SyntheticLM(cfg.vocab_size, seq, batch, seed=seed).batches())
    kw = dict(audio_frames=cfg.audio_frames, num_patches=cfg.num_patches,
              d_model=cfg.d_model, seed=seed)
    want = ref_add_modality_stubs(raw, cfg.family, **kw)
    got = add_modality_stubs(mine, cfg.family, **kw)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    ref_batch = {k: jnp.asarray(v) for k, v in want.items()}
    port_batch = {k: (torch.from_numpy(v) if v.dtype == np.float32
                      else torch.from_numpy(v).long()) for k, v in got.items()}
    return ref_batch, port_batch


def assert_close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL, msg=""):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, msg
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


def loss_and_grads_match(ref_model, model, params_np, params, ref_batch,
                         batch, atol_of_max=0.0):
    """fp32 loss at rtol 1e-5 and every gradient at rtol 1e-4, atol 1e-6,
    leaf by leaf in the reference's flatten order; ``atol_of_max`` raises
    a leaf's atol to that share of its largest gradient."""
    (ref_loss, _), ref_grads = jax.value_and_grad(
        ref_model.loss_fn, has_aux=True)(params_np, ref_batch)
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    loss, mets = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert mets["loss"] is loss
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(ref_flat) == len(grads)
    for (kp, want), got, (path, _) in zip(ref_flat, grads,
                                          tree.flatten_with_path(params)):
        assert jax.tree_util.keystr(kp) == path
        want = np.asarray(want)
        atol = max(ATOL, atol_of_max * float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol,
                                   err_msg=path)


def block_params(ref_init, key, cfg):
    """One block's parameters from a reference initialiser, in both
    packages (the port's through ``to_tensor``)."""
    p_np = jax.device_get(ref_init(jax.random.PRNGKey(key), cfg))
    return p_np, tree.tree_map(to_tensor, p_np)


def bf16_forward_matches(arch, seq=20):
    """The bf16 logits are fp32 in both packages, and the port's are as
    close to the reference's fp32 logits as the reference's own bf16 ones,
    within a factor of 1.5 (each relative to the largest fp32 logit). A
    bf16 forward rounds its products once per op in the port and keeps
    XLA's fp32 accumulators in the reference (``layers.py``'s note), which
    through a recurrence moves the logits by about as much as bf16 itself
    does. Returns (port, reference) bf16 logits and the parameters."""
    ref32 = pair(ref_get_config(arch, "reduced"))
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        ref_get_config(arch, "reduced"), dtype="bfloat16")
    ref_batch, batch = batches(cfg, seq=seq)
    fp32 = np.asarray(ref32[2].forward(ref32[4], ref_batch))
    want = np.asarray(ref_model.forward(params_np, ref_batch))
    with torch.no_grad():
        got = model.forward(params, batch)
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    assert got.shape == want.shape
    scale = float(np.abs(fp32).max())
    ref_err = float(np.abs(want - fp32).max()) / scale
    port_err = float(np.abs(got.numpy() - fp32).max()) / scale
    assert 0 < port_err < 1.5 * ref_err, (port_err, ref_err)
    return got, want, params, batch, cfg


def block_grads_match(ref_apply, apply, ref_cfg, cfg, p_np, p, x_np,
                      fwd_rtol=1e-5):
    """A block's forward and its gradients (every parameter and the input)
    against the reference's, through a fixed random cotangent."""
    ct_np = np.random.default_rng(9).standard_normal(x_np.shape).astype(
        np.float32)
    ref_out, vjp = jax.vjp(lambda pp, xx: ref_apply(pp, xx, ref_cfg), p_np,
                           jnp.asarray(x_np))
    ref_gp, ref_gx = vjp(jnp.asarray(ct_np))
    leaves = [a.clone().requires_grad_(True) for a in tree.leaves(p)]
    x = torch.from_numpy(x_np).requires_grad_(True)
    out = apply(tree.unflatten(p, leaves), x, cfg)
    grads = torch.autograd.grad(out, leaves + [x], torch.from_numpy(ct_np))
    assert_close(out, ref_out, rtol=fwd_rtol, msg="forward")
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_gp)[0]
    for (kp, want), got in zip(ref_flat, grads[:-1], strict=True):
        assert_close(got, want, msg=jax.tree_util.keystr(kp))
    assert_close(grads[-1], ref_gx, msg="dx")


# ------------------------------------------------------------------ trainers
def _edgc_kw(num_stages):
    return dict(policy="fixed", fixed_rank=8, num_stages=num_stages,
                total_iterations=STEPS)


def _tkw(micro, stash):
    return dict(total_steps=STEPS, log_every=1, num_microbatches=micro,
                schedule="1f1b", stash_policy=stash)


def ref_trainer(ref_cfg, micro=0, pipe=False):
    shape, axes = (((1, 1, 1), ("pipe", "data", "model")) if pipe
                   else ((1, 1), ("data", "model")))
    devs = np.array(jax.devices()[:1]).reshape(shape)
    mesh = Mesh(devs, axes, axis_types=(AxisType.Auto,) * len(axes))
    edgc = RefEDGCConfig(**_edgc_kw(ref_cfg.num_stages),
                         gds=RefGDSConfig(alpha=0.5, beta=0.25),
                         dac=RefDACConfig(window=2, adjust_limit=4))
    tcfg = RefTrainerConfig(adam=RefAdamConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=STEPS),
                            **_tkw(micro, "replay"))
    return RefTrainer(ref_build_model(ref_cfg), mesh, edgc, tcfg, seed=0)


def port_trainer(cfg, micro=0, pipe=None, stash="replay"):
    edgc = EDGCConfig(**_edgc_kw(cfg.num_stages),
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=2, adjust_limit=4))
    tcfg = TrainerConfig(adam=AdamConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=STEPS),
                         **_tkw(micro, stash))
    return Trainer(build_model(cfg), edgc, tcfg, seed=0, device="cpu",
                   pipe=pipe)


def family_data(cfg, reference=False, seq=32, batch=4, seed=3):
    """The trainers' batches (test_pipeline.py's ``_family_data``), from the
    reference's helpers or the port's."""
    lm, stubs = ((RefSyntheticLM, ref_add_modality_stubs) if reference
                 else (SyntheticLM, add_modality_stubs))
    for b in lm(cfg.vocab_size, seq, batch, seed=seed).batches():
        yield stubs(b, cfg.family, audio_frames=cfg.audio_frames,
                    num_patches=cfg.num_patches, d_model=cfg.d_model,
                    seed=seed)


def check_history(got, want, bar=TRAINER_BAR, same_bytes=True):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for a, b in zip(got, want, strict=True):
        assert np.isfinite(a["loss"]) and abs(a["loss"] - b["loss"]) < bar, (
            a["loss"], b["loss"])
        if same_bytes:
            assert a["bytes_synced"] == b["bytes_synced"]
            assert a["bytes_full"] == b["bytes_full"]
