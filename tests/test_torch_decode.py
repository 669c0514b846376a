"""The port's decode path (``attn_decode``, every family's ``init_cache`` and
``decode_step``) against the JAX reference on the same numpy-seeded inputs,
with the reference's weights carried across (``from_reference``) and its
caches too (``cache_from_reference``). fp32 unless stated; the bars are
rtol 1e-5 and an atol of 1e-6 times the largest reference value."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import encdec as ref_encdec
from repro.models import layers as ref_layers
from repro_torch import tree
from repro_torch.interop import cache_from_reference, to_tensor
from repro_torch.models import encdec, layers

from _torch_families import (assert_close, pair,
                             small_torch_thread_pool)  # noqa: F401

STEPS = 12
BATCH = 2
MAX_LEN = 16
# every arch but gpt2, whose decode the reference cannot run
DECODE_ARCHS = ["qwen2-0.5b", "qwen2.5-3b", "qwen3-32b", "llama3-405b",
                "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "phi-3-vision-4.2b",
                "xlstm-125m", "zamba2-7b", "whisper-base"]


def _tokens(cfg, steps=STEPS, batch=BATCH, seed=11):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, steps)).astype(np.int32)


def _frames(cfg, batch=BATCH, seed=1):
    return (np.random.default_rng(seed).standard_normal(
        (batch, cfg.audio_frames, cfg.d_model)) * 0.1).astype(np.float32)


def _caches(ref_cfg, cfg, ref_model, model, params_np, params, max_len,
            batch=BATCH):
    """Both packages' empty caches; Whisper's with the cross K/V of the
    same stub frames."""
    if cfg.family == "whisper":
        frames = _frames(cfg, batch)
        ref = ref_encdec.init_cache(ref_cfg, batch, max_len,
                                    frames=jnp.asarray(frames),
                                    params=params_np)
        mine = encdec.init_cache(cfg, batch, max_len,
                                 frames=torch.from_numpy(frames),
                                 params=params, device="cpu")
        return ref, mine
    return (ref_model.init_cache(batch, max_len),
            model.init_cache(batch, max_len, device="cpu"))


def _decode_both(arch, steps=STEPS, max_len=MAX_LEN, ref=True, **kw):
    """Decode ``steps`` tokens in both packages (the reference's
    ``decode_step`` under ``jax.jit``); returns each step's logits, both
    final caches and the pair."""
    p = pair(ref_get_config(arch, "reduced"), **kw)
    ref_cfg, cfg, ref_model, model, params_np, params = p
    toks = _tokens(cfg, steps)
    ref_cache, cache = _caches(*p, max_len)
    ref_dec = jax.jit(ref_model.decode_step)
    got, want = [], []
    for t in range(steps):
        logits, cache = model.decode_step(params, cache,
                                          torch.from_numpy(toks[:, t]).long())
        got.append(logits)
        if ref:
            ref_logits, ref_cache = ref_dec(params_np, ref_cache,
                                            jnp.asarray(toks[:, t]))
            want.append(np.asarray(ref_logits))
    return got, want, cache, jax.device_get(ref_cache), p, toks


# ---------------------------------------------------------------- attn_decode
ATTN_CASES = {
    # name: (heads, kv heads, rope, qkv bias, qk norm, window, cache slots)
    "mha": (4, 4, False, False, False, 0, 16),
    "gqa_rope": (4, 2, True, False, False, 0, 16),
    "bias_qknorm": (6, 2, True, True, True, 0, 16),
    "ring_wraps": (4, 2, True, True, False, 4, 4),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attn_decode_matches_reference(case):
    """Output and the new K/V over 10 tokens (the ring of 4 wraps twice)."""
    H, Hkv, rope, bias, qk_norm, window, C = ATTN_CASES[case]
    d, hd, B = 32, 8, 2
    rng = np.random.default_rng(3)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    p_np = {"wq": w(d, H * hd), "wk": w(d, Hkv * hd), "wv": w(d, Hkv * hd),
            "wo": w(H * hd, d)}
    if bias:
        for k, n in (("q_bias", H), ("k_bias", Hkv), ("v_bias", Hkv)):
            p_np[k] = rng.standard_normal(n * hd).astype(np.float32) * 0.1
    if qk_norm:
        for k in ("q_norm_scale", "k_norm_scale"):
            p_np[k] = (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32)
    p = tree.tree_map(to_tensor, p_np)
    kw = dict(num_heads=H, num_kv_heads=Hkv, head_dim=hd, use_rope=rope,
              window=window)
    ref_k = jnp.zeros((B, C, Hkv, hd), jnp.float32)
    ref_v = jnp.zeros((B, C, Hkv, hd), jnp.float32)
    k = torch.zeros((B, C, Hkv, hd))
    v = torch.zeros((B, C, Hkv, hd))
    for t in range(10):
        x = rng.standard_normal((B, 1, d)).astype(np.float32)
        want, ref_k, ref_v = ref_layers.attn_decode(
            p_np, jnp.asarray(x), ref_k, ref_v, jnp.asarray(t, jnp.int32), **kw)
        got, k2, v2 = layers.attn_decode(
            p, torch.from_numpy(x), k, v, torch.tensor(t, dtype=torch.int32),
            **kw)
        assert k2 is k and v2 is v
        assert_close(got, want, msg=f"out at {t}")
        assert_close(k, ref_k, msg=f"k at {t}")
        assert_close(v, ref_v, msg=f"v at {t}")


# ------------------------------------------------------- decode_step per family
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_steps_match_reference(arch):
    """12 steps of each reduced config: the logits at every step and the
    final cache, leaf by leaf."""
    got, want, cache, ref_cache, *_ = _decode_both(arch)
    for t, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, msg=f"{arch} logits at step {t}")
    ref_port = cache_from_reference(ref_cache)
    mine, theirs = tree.flatten_with_path(cache), tree.flatten_with_path(
        ref_port)
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert_close(a, b.numpy(), msg=path)
    assert cache["len"].dtype == torch.int32 and int(cache["len"]) == STEPS


def test_cache_from_reference_takes_the_reference_layout():
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        ref_get_config("qwen2-0.5b", "reduced"))
    got = cache_from_reference(jax.device_get(ref_model.init_cache(3, 7)))
    want = model.init_cache(3, 7, device="cpu")
    assert [(p, a.shape, a.dtype) for p, a in tree.flatten_with_path(got)] \
        == [(p, a.shape, a.dtype) for p, a in tree.flatten_with_path(want)]
    assert got["len"].ndim == 0 and got["len"].dtype == torch.int32


# --------------------------------------------- decode against teacher forcing
def _forward_batch(cfg, toks, frames=None):
    ref_b = {"tokens": jnp.asarray(toks)}
    b = {"tokens": torch.from_numpy(toks).long()}
    if cfg.family == "whisper":
        ref_b["frames"] = jnp.asarray(frames)
        b["frames"] = torch.from_numpy(frames)
    return ref_b, b


FORCED = {
    "dense": ("qwen2-0.5b", {}),
    "moe": ("qwen3-moe-235b-a22b", {"capacity_factor": 64.0}),
    "vlm": ("phi-3-vision-4.2b", {}),
    "xlstm": ("xlstm-125m", {}),
    "zamba": ("zamba2-7b", {}),
    "whisper": ("whisper-base", {}),
    "dense_ring": ("qwen2-0.5b", {"sliding_window": 4}),
    "moe_ring": ("qwen3-moe-235b-a22b", {"capacity_factor": 64.0,
                                         "sliding_window": 4}),
    "zamba_ring": ("zamba2-7b", {"sliding_window": 4}),
}


@pytest.mark.parametrize("case", list(FORCED))
def test_decode_matches_teacher_forced_forward(case):
    """Each step's decoded logits against the port's and the reference's
    forward over the same 12 tokens. The MoE runs at capacity factor 64,
    where the forward drops no token (decode never does: its capacity is
    B); the ring cases run the window of 4 in both. The VLM's decode sees
    no patch prefix (as the reference's), so it is held to the dense
    decoder's forward over its parameters."""
    arch, kw = FORCED[case]
    got, _, _, _, p, toks = _decode_both(arch, ref=False, **kw)
    ref_cfg, cfg, ref_model, model, params_np, params = p
    ref_b, b = _forward_batch(cfg, toks, _frames(cfg))
    if cfg.family == "vlm":
        from repro.models import transformer as ref_tf
        from repro_torch.models import transformer as tf
        want = np.asarray(ref_tf.forward(params_np, ref_b, ref_cfg))
        mine = tf.forward(params, b, cfg)
    else:
        want = np.asarray(ref_model.forward(params_np, ref_b))
        mine = model.forward(params, b)
    assert_close(mine.detach(), want, msg="port forward")
    decoded = torch.stack(got, dim=1)
    assert_close(decoded, want, msg=f"{case} decode against forward")


def test_moe_decode_keeps_the_tokens_the_forward_drops():
    """At the config's capacity factor (1.25) the forward drops tokens at
    capacity and decode, at capacity B, does not: they differ."""
    got, _, _, _, p, toks = _decode_both("qwen3-moe-235b-a22b", ref=False)
    ref_cfg, cfg, ref_model, model, params_np, params = p
    want = np.asarray(ref_model.forward(params_np,
                                        {"tokens": jnp.asarray(toks)}))
    diff = np.abs(torch.stack(got, 1).numpy() - want).max()
    assert diff > 1e-2 * np.abs(want).max()


# ------------------------------------------------------------------- gpt2
def test_reference_gpt2_decode_step_raises():
    """The reference's learned-position decode sends the 0-d cache length
    to its vmap branch, which raises on the first step."""
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        ref_get_config("gpt2", "reduced"))
    with pytest.raises(ValueError, match="vmap"):
        ref_model.decode_step(params_np, ref_model.init_cache(BATCH, MAX_LEN),
                              jnp.zeros((BATCH,), jnp.int32))


def test_gpt2_decode_matches_reference_forward():
    """gpt2-fidelity's decode (learned positions, LayerNorm, plain GeLU,
    tied head) against the reference's teacher-forced forward."""
    got, _, cache, _, p, toks = _decode_both("gpt2", ref=False)
    ref_cfg, cfg, ref_model, model, params_np, params = p
    want = np.asarray(ref_model.forward(params_np,
                                        {"tokens": jnp.asarray(toks)}))
    assert_close(torch.stack(got, dim=1), want)
    assert int(cache["len"]) == STEPS


# ------------------------------------------------------------------- whisper
def test_whisper_cross_kv_from_frames_and_memory():
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        ref_get_config("whisper-base", "reduced"))
    frames = _frames(cfg)
    want = ref_encdec.init_cache(ref_cfg, BATCH, 8, frames=jnp.asarray(frames),
                                 params=params_np)
    got = encdec.init_cache(cfg, BATCH, 8, frames=torch.from_numpy(frames),
                            params=params, device="cpu")
    enc_out = encdec.encode(params, torch.from_numpy(frames), cfg)
    from_mem = encdec.init_cache(cfg, BATCH, 8, enc_out=enc_out, params=params,
                                 device="cpu")
    for key in ("cross_k", "cross_v"):
        assert got[key].shape == (cfg.num_layers, BATCH, cfg.audio_frames,
                                  cfg.num_kv_heads, cfg.hd)
        assert_close(got[key], want[key], msg=key)
        assert torch.equal(from_mem[key], got[key])
    bare = encdec.init_cache(cfg, BATCH, 8, device="cpu")
    assert not bare["cross_k"].any() and bare["k"].shape[2] == 8


# --------------------------------------------------------- past the capacity
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-base"])
def test_full_cache_clamps_past_capacity(arch):
    """A full cache of 4 slots decoded for 7 tokens: the write slot stays
    at 3, as ``dynamic_update_slice`` clamps; Whisper's ``dec_pos`` of 5
    rows clamps its row at 4, as ``dynamic_slice_in_dim`` does."""
    kw = {"max_position": 5} if arch == "whisper-base" else {}
    got, want, cache, ref_cache, *_ = _decode_both(arch, steps=7, max_len=4,
                                                   **kw)
    for t, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, msg=f"step {t}")
    want = dict(tree.flatten_with_path(cache_from_reference(ref_cache)))
    for path, a in tree.flatten_with_path(cache):
        assert_close(a, want[path].numpy(), msg=path)


# ------------------------------------------------------------------- bf16
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "xlstm-125m", "zamba2-7b",
                                  "whisper-base"])
def test_bf16_decode_within_reference_distance(arch):
    """bf16 decode logits are fp32, and as close to the reference's fp32
    decode as the reference's own bf16 decode, within a factor of 1.5
    (each relative to the largest fp32 logit), as
    ``_torch_families.bf16_forward_matches`` holds the forwards. (The
    reference's bf16 MoE decode does not run on XLA's CPU backend: its
    dispatch product is a bf16 x bf16 = f32 dot that backend lacks.)"""
    _, fp32, *_ = _decode_both(arch)
    got, want, *_ = _decode_both(arch, dtype="bfloat16")
    fp32, want = np.stack(fp32, 1), np.stack(want, 1)
    got = torch.stack(got, 1)
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    scale = float(np.abs(fp32).max())
    ref_err = float(np.abs(want - fp32).max()) / scale
    port_err = float(np.abs(got.numpy() - fp32).max()) / scale
    assert 0 < port_err < 1.5 * ref_err, (port_err, ref_err)


def test_bf16_decode_to_forward_within_reference_distance():
    """Deep bf16 decode against the same package's teacher-forced forward:
    the port's distance (largest element over the largest logit) within
    1.5 times the reference's own, at 16 layers, where rounding every
    product at other GEMM shapes sets the floor in both packages."""
    dist = {}
    for name in ("port", "ref"):
        got, want, _, _, p, toks = _decode_both(
            "qwen2-0.5b", ref=(name == "ref"), dtype="bfloat16",
            num_layers=16)
        ref_cfg, cfg, ref_model, model, params_np, params = p
        if name == "ref":
            fwd = np.asarray(ref_model.forward(
                params_np, {"tokens": jnp.asarray(toks)}))
            dec = np.stack(want, 1)
        else:
            fwd = model.forward(params, {"tokens": torch.from_numpy(
                toks).long()}).numpy()
            dec = torch.stack(got, 1).numpy()
        dist[name] = float(np.abs(dec - fwd).max() / np.abs(fwd).max())
    assert dist["ref"] > 0 and dist["port"] < 1.5 * dist["ref"], dist


def test_vlm_prefill_patches_raises_as_the_reference():
    from repro_torch.models import vlm
    with pytest.raises(NotImplementedError, match="forward"):
        vlm.prefill_patches(None, None, None, None)


def test_default_max_len_and_cache_dtypes():
    """The reference's defaults: 32768 slots (dense, MoE, VLM, Zamba2),
    448 (Whisper), none for the xLSTM's state; the ring's C is the window."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    for arch, kv, slots in (
            ("qwen2-0.5b", lambda c: c["stages"][0]["k"], 32768),
            ("qwen3-moe-235b-a22b", lambda c: c["stages"][0]["k"], 32768),
            ("phi-3-vision-4.2b", lambda c: c["stages"][0]["k"], 32768),
            ("zamba2-7b", lambda c: c["groups"][0]["attn_k"], 32768),
            ("whisper-base", lambda c: c["k"], 448)):
        cfg = get_config(arch, "reduced")
        leaf = kv(build_model(cfg).init_cache(1, device="meta"))
        assert leaf.shape[-3] == slots and leaf.dtype == cfg.torch_dtype, arch
    cfg = dataclasses.replace(get_config("qwen2-0.5b", "reduced"),
                              sliding_window=6)
    cache = build_model(cfg).init_cache(1, device="meta")
    assert cache["stages"][0]["k"].shape[2] == 6
    xl = build_model(get_config("xlstm-125m", "reduced")).init_cache(
        2, device="cpu")
    assert xl["mlstm"]["s"].dtype == torch.float32
    assert float(xl["slstm"]["m"].max()) == -10.0
