"""Dense-model parity: with the reference's weights carried across by
``from_reference``, the port's loss and gradients agree with the
reference's in fp32 on gpt2-fidelity (LayerNorm, plain GeLU, learned
positions, tied embeddings), on qwen2-0.5b and qwen2.5-3b reduced (RMSNorm,
RoPE, GQA, QKV bias, gated SiLU), qwen3-32b reduced (qk-norm, head_dim 64
over 4 heads of a 256 model) and llama3-405b reduced (untied head,
head_dim 64). The batches come from both packages' SyntheticLM."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.model import build_model as ref_build_model

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import from_reference
from repro_torch.models.model import build_model

ARCHS = [("gpt2", 32), ("qwen2-0.5b", 24), ("qwen2.5-3b", 32),
         ("qwen3-32b", 32), ("llama3-405b", 32)]


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def _pair(arch, seq):
    ref_cfg = ref_get_config(arch, "reduced")
    cfg = get_config(arch, "reduced")
    port_fields, ref_fields = dataclasses.asdict(cfg), dataclasses.asdict(ref_cfg)
    for name in port_fields.keys() & ref_fields.keys():
        assert port_fields[name] == ref_fields[name], name
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(3))
    params = from_reference({"params": jax.device_get(ref_params)})["params"]
    ref_batch = next(RefSyntheticLM(cfg.vocab_size, seq, 2, seed=5).batches())
    batch = next(SyntheticLM(cfg.vocab_size, seq, 2, seed=5).batches())
    for k in ref_batch:
        np.testing.assert_array_equal(np.asarray(batch[k]), np.asarray(ref_batch[k]))
    return (ref_model, ref_params, ref_batch), (model, params, _port_batch(batch))


@pytest.mark.parametrize("arch,seq", ARCHS)
def test_loss_and_grads_match_reference(arch, seq):
    (ref_model, ref_params, ref_batch), (model, params, batch) = _pair(arch, seq)
    (ref_loss, _), ref_grads = jax.value_and_grad(
        ref_model.loss_fn, has_aux=True)(ref_params, ref_batch)
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    loss, mets = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert mets["loss"] is loss
    np.testing.assert_allclose(loss.detach().item(), float(ref_loss), rtol=1e-5)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(ref_flat) == len(grads)
    for (kp, want), got, (path, _) in zip(ref_flat, grads,
                                          tree.flatten_with_path(params)):
        assert jax.tree_util.keystr(kp) == path
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("arch,seq", ARCHS)
def test_forward_logits_match_reference(arch, seq):
    (ref_model, ref_params, ref_batch), (model, params, batch) = _pair(arch, seq)
    want = np.asarray(ref_model.forward(ref_params, ref_batch))
    with torch.no_grad():
        got = model.forward(params, batch).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_remat_gives_the_same_grads():
    """Checkpointing each block (cfg.remat) recomputes, it changes nothing."""
    cfg = get_config("gpt2", "reduced")
    params = build_model(cfg).init(0, "cpu")
    batch = _port_batch(next(SyntheticLM(cfg.vocab_size, 16, 2, seed=1).batches()))
    out = []
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss, _ = model.loss_fn(tree.unflatten(params, leaves), batch)
        out.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_blockwise_attention_blocks_do_not_change_values():
    """Query blocks of any size give the one-block result."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 2, 8)).astype(np.float32))
    full = L.blockwise_attention(q, k, v, causal=True, block_q=64)
    for bq in (8, 16, 24):
        torch.testing.assert_close(
            L.blockwise_attention(q, k, v, causal=True, block_q=bq), full,
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("family,arch", [("xlstm", "xlstm-125m"),
                                         ("zamba", "zamba2-7b"),
                                         ("whisper", "whisper-base")])
def test_families_still_to_port_raise_naming_item_9(family, arch):
    """The three families ROADMAP item 9 left to port (9d-9f) now build,
    and their reduced configs' fp32 losses match the reference's from the
    reference's weights (``test_torch_ssm.py``, ``test_torch_hybrid.py``
    and ``test_torch_encdec.py`` hold their gradients); an unregistered
    family still raises."""
    from repro.data.pipeline import add_modality_stubs as ref_stubs
    from repro_torch.data.pipeline import add_modality_stubs
    from repro_torch.models.model import ModelConfig
    assert build_model(ModelConfig(family=family)).config.family == family
    (ref_model, ref_params, ref_batch), (model, params, batch) = _pair(arch, 16)
    cfg = model.config
    kw = dict(audio_frames=cfg.audio_frames, d_model=cfg.d_model, seed=2)
    ref_batch = ref_stubs(dict(ref_batch), family, **kw)
    batch.update({k: torch.from_numpy(v) for k, v in add_modality_stubs(
        {"tokens": batch["tokens"].numpy()}, family, **kw).items()
        if k != "tokens"})
    ref_loss, _ = ref_model.loss_fn(ref_params, ref_batch)
    with torch.no_grad():
        loss, _ = model.loss_fn(params, batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    with pytest.raises(KeyError, match="unknown model family"):
        build_model(ModelConfig(family="nope"))


def test_registries_hold_the_ported_families():
    from repro.configs import ARCHS as REF_ARCHS
    from repro.pipeline.adapters import adapter_families as ref_adapters
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import ModelConfig
    from repro_torch.pipeline.adapters import adapter_families
    assert ARCHS == REF_ARCHS and len(ARCHS) == 11
    for family in ("dense", "moe", "vlm", "xlstm", "zamba", "whisper"):
        assert build_model(ModelConfig(family=family)).config.family == family
    assert adapter_families() == ref_adapters() == [
        "dense", "moe", "vlm", "whisper", "xlstm", "zamba"]
