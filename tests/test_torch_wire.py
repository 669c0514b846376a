"""Wire-codec parity: the port's bit packing, quantizer, codec selection,
byte ledgers and coded bucketed sync against the reference, fed the same
numpy-seeded inputs.

The reference's ``ops.pack_bits``/``unpack_bits`` run its Pallas kernels in
interpret mode at 512 words and more, and its oracle below that, as its
own tests run them on the CPU. Packed words are compared through numpy
``uint32`` views. Pack, quantize, roundtrip and the ledgers must agree
bit for bit; the coded sync agrees at the fp32 bar of
``test_torch_compressor.py`` (rtol 1e-5, atol 1e-6 x max|array|), with
one stated exception on coded factor payloads (``_Replay``).
"""
import ctypes
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import AxisType, Mesh

from repro.configs.gpt2 import GPT2_FIDELITY as REF_GPT2_FIDELITY
from repro.core import EDGCConfig as RefEDGCConfig
from repro.core import SyncConfig as RefSyncConfig
from repro.core import bucketing as ref_bucketing
from repro.core import comm_model as ref_comm
from repro.core import compressor as ref_comp
from repro.core import powersgd as ref_psgd
from repro.core import wire as ref_wire
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.kernels import ops as ref_ops
from repro.models.model import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.pipeline.sync import stage_wire_bytes as ref_stage_wire_bytes
from repro.train.faults import RecoveryConfig as RefRecoveryConfig
from repro.train.faults import parse_inject as ref_parse_inject
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch import interop, tree
from repro_torch.configs.gpt2 import GPT2_FIDELITY
from repro_torch.core import EDGCConfig, bucketing, compressor, powersgd, wire
from repro_torch.core.comm_model import HardwareSpec
from repro_torch.core.config import SyncConfig
from repro_torch.core.sync_executor import SyncExecutor
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import pack
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.optim.adam import AdamConfig
from repro_torch.pipeline.sync import stage_wire_bytes
from repro_torch.train.faults import RecoveryConfig, parse_inject
from repro_torch.train.trainer import Trainer, TrainerConfig

RTOL, ATOL = 1e-5, 1e-6
MODES = ["raw", "quant8", "quant4", "entropy"]


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol * scale)


def _u32(words) -> np.ndarray:
    """Packed words of either package as a numpy uint32 array."""
    if isinstance(words, torch.Tensor):
        return words.view(torch.int32).numpy().view(np.uint32)
    return np.asarray(words).astype(np.uint32)


# ---------------------------------------------------------------- pack/unpack
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [1, 7, 2047, 512 * 8 + 3, 20000])
def test_pack_unpack_match_reference(bits, n):
    codes = np.random.default_rng(n * bits).integers(
        0, 1 << bits, size=n).astype(np.int32)
    want = ref_ops.pack_bits(jnp.asarray(codes), bits)
    got = pack.pack_words(torch.from_numpy(codes), bits)
    assert got.dtype == torch.uint32 and got.shape == (-(-n // (32 // bits)),)
    np.testing.assert_array_equal(_u32(got), _u32(want))
    back = pack.unpack_words(got, bits, n)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), codes)
    # the port unpacks the reference's words and the reference the port's
    np.testing.assert_array_equal(
        pack.unpack_words(torch.from_numpy(_u32(want).view(np.int32))
                          .view(torch.uint32), bits, n).numpy(), codes)
    np.testing.assert_array_equal(
        np.asarray(ref_ops.unpack_bits(jnp.asarray(_u32(got)), bits, n)),
        codes)


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_full_range_codes_set_the_top_bit(bits):
    """Codes up to 2**bits - 1 fill the top field, so words >= 2**31 (the
    int64 oracle must narrow them without loss)."""
    codes = np.full(64, (1 << bits) - 1, np.int32)
    got = _u32(pack.pack_words(torch.from_numpy(codes), bits))
    assert (got == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(got, _u32(ref_ops.pack_bits(
        jnp.asarray(codes), bits)))


def test_pack_wrappers_on_the_cpu_count_no_launches():
    before = [k.launches for k in pack.KERNELS]
    w = pack.pack_words(torch.arange(9, dtype=torch.int32), 8)
    pack.unpack_words(w, 8, 9)
    assert [k.launches for k in pack.KERNELS] == before
    with pytest.raises(ValueError, match="bits"):
        pack.pack_words(torch.arange(9, dtype=torch.int32), 2)


# ------------------------------------------- the launch layer, without a card
class _FakeLib:
    """Records each call of a C entry point against its declared argtypes."""

    def __init__(self):
        self.calls, self.rc = [], 0

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name == "repro_cuda_error_string":
            fn = lambda code: b"fake error"
        else:
            lib = self

            def fn(*args):
                want = {ctypes.c_void_p: ctypes.c_void_p, ctypes.c_int: int,
                        ctypes.c_longlong: int}
                assert len(args) == len(fn.argtypes), (name, args)
                for a, t in zip(args, fn.argtypes):
                    assert isinstance(a, want[t]), (name, a, t)
                lib.calls.append((name, args))
                return lib.rc
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """The pack wrappers' CUDA branch on CPU tensors, with a recording
    library in place of the built one."""
    import contextlib
    import types
    lib = _FakeLib()
    monkeypatch.setattr(pack.build, "load", lambda name: lib)
    monkeypatch.setattr(pack, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=77))
    return lib


def test_pack_launches_match_the_declared_c_signatures(fake_card):
    codes = torch.arange(4099, dtype=torch.int32)
    before = [k.launches for k in pack.KERNELS]
    words = pack.pack_words(codes, 4)
    out = pack.unpack_words(words, 4, 4099)
    assert [k.launches - b for k, b in zip(pack.KERNELS, before)] == [1, 1]
    assert words.shape == (513,) and words.dtype == torch.uint32
    assert out.shape == (4099,) and out.dtype == torch.int32
    (p_name, p_args), (u_name, u_args) = fake_card.calls
    assert (p_name, u_name) == ("repro_pack_words", "repro_unpack_words")
    assert p_args[0].value == codes.data_ptr()
    assert p_args[1].value == words.data_ptr() == u_args[0].value
    assert u_args[1].value == out.data_ptr()
    assert p_args[2:4] == (4099, 4) and u_args[2:4] == (4099, 4)
    assert p_args[4].value == u_args[4].value == 77
    # what the kernels do not take is refused before any launch
    with pytest.raises(TypeError, match="int32"):
        pack.pack_words(codes.long(), 8)
    with pytest.raises(TypeError, match="uint32"):
        pack.unpack_words(words.view(torch.int32), 4, 10)
    with pytest.raises(ValueError, match="do not fit"):
        pack.unpack_words(words, 4, 513 * 8 + 1)
    fake_card.rc = 1
    with pytest.raises(RuntimeError, match="fake error"):
        pack.pack_words(codes, 8)
    assert [k.launches - b for k, b in zip(pack.KERNELS, before)] == [1, 1]


# ----------------------------------------------------------------- quantizer
def _payloads():
    rng = np.random.default_rng(5)
    return {
        "normal": _np((5000,), 1),
        "ragged_small": _np((37,), 2, 1e-3),
        "mixed_scale": np.concatenate([_np((1024,), 3, 1e-6),
                                       _np((2000,), 4, 30.0)]),
        "zeros": np.zeros(3000, np.float32),
        "half_steps": (rng.integers(-20, 20, 4096) * 0.5).astype(np.float32),
    }


@pytest.mark.parametrize("mode", ["quant8", "quant4"])
@pytest.mark.parametrize("name", list(_payloads()))
def test_quantize_and_roundtrip_match_reference(mode, name):
    x = _payloads()[name]
    codec, ref_codec = wire.resolve_codec(mode), ref_wire.resolve_codec(mode)
    assert (codec.bits, codec.group) == (ref_codec.bits, ref_codec.group)
    codes, scales = wire.quantize(torch.from_numpy(x), codec)
    ref_codes, ref_scales = ref_wire.quantize(jnp.asarray(x), ref_codec)
    assert codes.dtype == torch.int32 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(ref_scales))
    deq = wire.dequantize(codes, scales, codec)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(ref_wire.dequantize(ref_codes, ref_scales,
                                                    ref_codec)))
    rt = wire.roundtrip(torch.from_numpy(x), codec)
    np.testing.assert_array_equal(
        rt.numpy(), np.asarray(ref_wire.roundtrip(jnp.asarray(x), ref_codec)))
    np.testing.assert_array_equal(rt.numpy(), deq.numpy())
    if name == "zeros":
        assert (scales.numpy() == 1.0).all() and (rt.numpy() == 0).all()


@pytest.mark.parametrize("mode", ["quant8", "quant4"])
@pytest.mark.parametrize("nan_at", [(0,), (517,), (0, 517), (3, 7, 1023)],
                         ids=lambda t: "nan@" + "+".join(map(str, t)))
def test_nan_payload_codes_as_the_reference(mode, nan_at):
    """A NaN element codes as 0, as XLA's float-to-int cast makes it. A
    CPU cast to int32 gives INT_MIN, and its sign bit lands in the top
    slot of the packed word (element 3 at 8 bits, 7 at 4 bits), which the
    roundtrip then decodes as the wrong value there. Codes, scales, words
    and the roundtrip agree with the reference bit for bit, NaN positions
    equal."""
    x = np.linspace(-1.0, 1.0, 1024 + 300).astype(np.float32)
    x[list(nan_at)] = np.nan
    codec, ref_codec = wire.resolve_codec(mode), ref_wire.resolve_codec(mode)
    codes, scales = wire.quantize(torch.from_numpy(x), codec)
    ref_codes, ref_scales = ref_wire.quantize(jnp.asarray(x), ref_codec)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(ref_scales))
    assert (codes.numpy()[list(nan_at)] == 0).all()
    np.testing.assert_array_equal(
        _u32(pack.pack_words(codes, codec.bits)),
        _u32(ref_ops.pack_bits(ref_codes, ref_codec.bits)))
    rt = wire.roundtrip(torch.from_numpy(x), codec)
    want = np.asarray(ref_wire.roundtrip(jnp.asarray(x), ref_codec))
    np.testing.assert_array_equal(rt.numpy(), want)
    assert np.isfinite(rt.numpy()).all()     # the coded payload is finite


def test_roundtrip_arr_and_coded_psum_keep_shape_and_dtype():
    x = torch.from_numpy(_np((3, 40, 50), 6)).to(torch.bfloat16)
    codec = wire.resolve_codec("quant8")
    y = wire.roundtrip_arr(x, codec)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    want = ref_wire.roundtrip_arr(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                  ref_wire.resolve_codec("quant8"))
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(want, np.float32))
    assert wire.roundtrip_arr(x, None) is x
    seen = []
    psum = wire.coded_psum(lambda a: seen.append(a) or a, codec)
    assert torch.equal(psum(x), y) and len(seen) == 1
    ident = lambda a: a
    assert wire.coded_psum(ident, None) is ident


# -------------------------------------------------------- small functions
@pytest.mark.parametrize("ref_h", [-6.0, -1.3, 0.0, 2.5])
def test_select_bits_and_resolve_codec_match_reference(ref_h):
    for dh in np.linspace(-4.0, 2.0, 49):
        h = ref_h + float(dh)
        assert wire.select_bits(h, ref_h) == ref_wire.select_bits(h, ref_h)
        for mode in MODES:
            for args in [(), (h,), (h, ref_h), (None, ref_h)]:
                got = wire.resolve_codec(mode, *args)
                want = ref_wire.resolve_codec(mode, *args)
                assert (got is None) == (want is None)
                if got is not None:
                    assert (got.bits, got.group, got.qmax) == (
                        want.bits, want.group, want.qmax)
    with pytest.raises(ValueError, match="wire"):
        wire.resolve_codec("gzip")
    with pytest.raises(ValueError, match="bits"):
        wire.ChunkCodec(bits=3)
    with pytest.raises(ValueError, match="group"):
        wire.ChunkCodec(group=0)


def test_coded_bytes_and_predicted_code_bits_match_reference():
    codecs = [None, wire.ChunkCodec(8, 1024), wire.ChunkCodec(4, 256),
              wire.ChunkCodec(4, 7), wire.ChunkCodec(16, 1), wire.ChunkCodec(2, 3)]
    for c in codecs:
        rc = None if c is None else ref_wire.ChunkCodec(c.bits, c.group)
        for n in [-3, 0, 1, 2, 7, 8, 9, 255, 256, 257, 1023, 1025, 96_495_360]:
            for raw in (2, 4):
                assert wire.coded_bytes(n, c, raw) == ref_wire.coded_bytes(
                    n, rc, raw)
    for h in [-8.0, -1.0, 0.0, 3.3]:
        for step in [-1.0, 0.0, 1e-6, 0.01, 1.0, 7.5]:
            assert wire.predicted_code_bits(h, step) == \
                ref_wire.predicted_code_bits(h, step)


# ----------------------------------------------------------- the gpt2 tree
def _gpt2(policy="fixed", **kw):
    shapes = jax.eval_shape(ref_build_model(REF_GPT2_FIDELITY).init,
                            jax.random.PRNGKey(0))
    ref_leaves = ref_comp.classify_leaves(shapes, REF_GPT2_FIDELITY.num_layers,
                                          4, min_dim=64)
    params = build_model(GPT2_FIDELITY).init(0, "cpu")
    leaves = compressor.classify_leaves(params, GPT2_FIDELITY.num_layers, 4,
                                        min_dim=64)
    plan = compressor.make_plan(policy, leaves, **kw)
    ref_plan = ref_comp.make_plan(policy, ref_leaves, **kw)
    assert plan.ranks == ref_plan.ranks
    return shapes, params, (leaves, plan), (ref_leaves, ref_plan)


# Coded bytes of the gpt2-fidelity fixed rank-8 plan at 4 B/elem raw
# (``benchmarks/sync_bucketing.py``; ``BENCH_sync.json`` wire section).
BENCH_BYTES = {"raw": 3250176, "quant8": 815784, "quant4": 418968}


@pytest.mark.parametrize("mode", MODES)
def test_byte_ledgers_match_reference(mode):
    _, _, (leaves, plan), (ref_leaves, ref_plan) = _gpt2("fixed", fixed_rank=8)
    codec = wire.resolve_codec(mode)
    ref_codec = ref_wire.resolve_codec(mode)
    for bpe in (2, 4):
        got = compressor.plan_wire_bytes(leaves, plan, bpe, codec=codec)
        assert got == ref_comp.plan_wire_bytes(ref_leaves, ref_plan, bpe,
                                               codec=ref_codec)
        assert stage_wire_bytes(leaves, plan, 4, bpe, codec=codec) == \
            ref_stage_wire_bytes(ref_leaves, ref_plan, 4, bpe, codec=ref_codec)
    bench = BENCH_BYTES["quant8" if mode == "entropy" else mode]
    assert compressor.plan_wire_bytes(leaves, plan, 4, codec=codec)[0] == bench
    for chunk_bytes in (0, 4096):
        layout = bucketing.make_bucket_layout(leaves, plan,
                                              chunk_bytes=chunk_bytes)
        ref_layout = ref_bucketing.make_bucket_layout(
            ref_leaves, ref_plan, chunk_bytes=chunk_bytes)
        chunks = bucketing.sync_chunks(layout)
        ref_chunks = ref_bucketing.sync_chunks(ref_layout)
        for c, rc in zip(chunks, ref_chunks, strict=True):
            assert (c.members, c.group and c.group.key) == (
                rc.members, rc.group and rc.group.key)
            for bpe in (None, 2):
                assert c.wire_bytes(bpe, codec) == rc.wire_bytes(bpe, ref_codec)


class _Replay:
    """Collective hooks for the two packages' coded syncs.

    ``record`` is the reference's psum_mean: an identity that keeps each
    coded payload. ``replay`` is the port's: it holds the port's payload
    against the reference's and returns the reference's, as a collective
    returns what every worker sent. Both count their calls.

    Coding cannot be compared at the fp32 bar on factor payloads: P and Q
    come out of fp32 products summed in another order, and where the two
    values straddle a rounding boundary of the quantizer their codes
    differ by one. ``replay`` allows that, and only that: each element
    agrees at the bar or differs by at most one step of the payload's
    coarsest scale, and such flips are under 0.1% of the elements.
    Returning the reference's payload keeps one flip from spreading, so
    everything downstream is held at the fp32 bar.
    """

    def __init__(self, codec):
        self.codec, self.sent, self.calls, self.flips = codec, [], 0, 0

    def record(self, x):
        self.sent.append(np.asarray(x))
        self.calls += 1
        return x

    def replay(self, x):
        want = self.sent[self.calls]
        self.calls += 1
        got = x.float().numpy()
        bar = RTOL * np.abs(want) + ATOL * max(1.0, float(np.abs(want).max()))
        off = np.abs(got - want.astype(np.float32)) > bar
        step = float(np.abs(want).max()) / self.codec.qmax
        assert np.abs(got - want)[off].max(initial=0.0) <= step * (1 + 1e-5)
        assert off.sum() <= 1e-3 * off.size, (off.sum(), off.size)
        self.flips += int(off.sum())
        return torch.from_numpy(np.array(want, np.float32)).to(x.dtype)


def _coded_setup(policy, **kw):
    shapes, params, (leaves, plan), (ref_leaves, ref_plan) = _gpt2(policy, **kw)
    layout = bucketing.make_bucket_layout(leaves, plan)
    ref_layout = ref_bucketing.make_bucket_layout(ref_leaves, ref_plan)
    flat = tree.flatten_with_path(params)
    q_np = {p: _np(tuple(dict(flat)[p].shape[:-2]) + (dict(flat)[p].shape[-1],
                                                        r), 200 + i)
            for i, (p, r) in enumerate(plan.ranks)}
    per_leaf = {p: powersgd.LowRankState(
        q=torch.from_numpy(q_np[p]), err=torch.zeros(dict(flat)[p].shape))
        for p, _ in plan.ranks}
    ref_per_leaf = {p: ref_psgd.LowRankState(
        q=jnp.asarray(q_np[p]), err=jnp.zeros(dict(flat)[p].shape))
        for p, _ in plan.ranks}
    state = bucketing.stack_state(per_leaf, layout)
    state.update(bucketing.init_flat_ef(layout))
    ref_state = ref_bucketing.stack_state(ref_per_leaf, ref_layout)
    ref_state.update(ref_bucketing.init_flat_ef(ref_layout))

    def grads(seed):
        g_np = [_np(tuple(t.shape), seed + i) for i, (_, t) in enumerate(flat)]
        return (tree.unflatten(params, [torch.from_numpy(g) for g in g_np]),
                jax.tree_util.tree_unflatten(
                    jax.tree_util.tree_structure(shapes),
                    [jnp.asarray(g) for g in g_np]))

    return (layout, state), (ref_layout, ref_state), grads


@pytest.mark.parametrize("mode", ["quant8", "quant4"])
@pytest.mark.parametrize("policy,kw", [("fixed", dict(fixed_rank=8)),
                                       ("none", {})])
def test_coded_bucketed_sync_matches_reference(mode, policy, kw):
    """Two coded steps (the second adds back the first's residuals): synced
    gradients, factor states and every ef:<path> entry agree at the fp32
    bar, the payloads agree as ``_Replay`` states, and both packages issue
    2 G + B collectives per step."""
    (layout, state), (ref_layout, ref_state), grads = _coded_setup(policy, **kw)
    codec, ref_codec = wire.resolve_codec(mode), ref_wire.resolve_codec(mode)
    assert sorted(k for k in state if k.startswith("ef:")) == sorted(
        k for k in ref_state if k.startswith("ef:"))
    for step in range(2):
        g, ref_g = grads(100 + 50 * step)
        hooks = _Replay(codec)
        ref_synced, ref_state = ref_bucketing.bucketed_sync_grads(
            ref_g, ref_state, ref_layout, hooks.record, codec=ref_codec)
        ref_calls, hooks.calls = hooks.calls, 0
        synced, state = bucketing.bucketed_sync_grads(g, state, layout,
                                                      hooks.replay, codec=codec)
        want = 2 * len(layout.groups) + len(layout.buckets)
        assert hooks.calls == ref_calls == want
        if policy == "none":
            assert hooks.flips == 0     # no factors: coding is exact
        for (_, got), ref_leaf in zip(tree.flatten_with_path(synced),
                                      jax.tree_util.tree_leaves(ref_synced)):
            _close(got, ref_leaf)
        assert sorted(state) == sorted(ref_state)
        for key, st in state.items():
            if key.startswith("ef:"):
                _close(st, ref_state[key])
            else:
                _close(st.err, ref_state[key].err)
                _close(st.q, ref_state[key].q)


def test_coded_sync_through_compressor_and_executor():
    (layout, state), _, grads = _coded_setup("fixed", fixed_rank=8)
    _, _, (leaves, plan), _ = _gpt2("fixed", fixed_rank=8)
    g, _ = grads(7)
    codec = wire.resolve_codec("quant8")
    want, want_state = bucketing.bucketed_sync_grads(g, state, layout,
                                                     lambda x: x, codec=codec)
    ex = SyncExecutor(SyncConfig(wire="quant8"), "flat", plan=plan)
    assert ex.codec == codec
    got, got_state = ex.sync(g, state, lambda x: x)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert torch.equal(a, b)
    assert torch.equal(got_state[next(k for k in state if k.startswith("ef:"))],
                       want_state[next(k for k in state if k.startswith("ef:"))])
    with pytest.raises(ValueError, match="bucketed"):
        compressor.sync_grads(g, {}, plan, lambda x: x, bucketed=False,
                              codec=codec)
    with pytest.raises(ValueError, match="wire"):
        SyncExecutor(SyncConfig(wire="gzip"), "flat", plan=plan)
    with pytest.raises(ValueError, match="bucketed"):
        SyncExecutor(SyncConfig(wire="quant8", bucketed=False), "flat",
                     plan=plan)
    assert SyncExecutor(SyncConfig(wire="quant4"), "flat",
                        plan=plan).codec.bits == 4


def test_wire_ef_state_init_and_resize_match_reference():
    """``ef:`` entries: one zero fp32 residual per flat-bucket member at
    init, and across a re-plan kept where the member stayed flat, zeros
    where it left a shape group, gone where it joined one."""
    shapes, params, (leaves, plan), (ref_leaves, ref_plan) = _gpt2(
        "fixed", fixed_rank=8)
    layout = bucketing.make_bucket_layout(leaves, plan)
    state = compressor.init_compressor_state(params, plan, 0, layout=layout,
                                             wire_ef=True)
    ref_state = ref_comp.init_compressor_state(
        shapes, ref_plan, jax.random.PRNGKey(0),
        layout=ref_bucketing.make_bucket_layout(ref_leaves, ref_plan),
        wire_ef=True)
    assert sorted(state) == sorted(ref_state)
    assert bucketing.is_stacked_state({k: v for k, v in state.items()
                                       if k.startswith("ef:")})
    for k, v in state.items():
        if k.startswith("ef:"):
            assert v.dtype == torch.float32 and not v.any()
            assert tuple(v.shape) == tuple(ref_state[k].shape)
    # mark every residual, then move to the uncompressed plan and back
    marked = {k: (v + 1.0 if k.startswith("ef:") else v)
              for k, v in state.items()}
    none_plan = compressor.make_plan("none", leaves)
    none_layout = bucketing.make_bucket_layout(leaves, none_plan)
    moved = compressor.resize_compressor_state(
        marked, none_plan, 1, old_layout=layout, new_layout=none_layout)
    ref_moved = ref_comp.resize_compressor_state(
        {k: (v + 1.0 if k.startswith("ef:") else v)
         for k, v in ref_state.items()}, ref_comp.make_plan("none", ref_leaves),
        jax.random.PRNGKey(1),
        old_layout=ref_bucketing.make_bucket_layout(ref_leaves, ref_plan),
        new_layout=ref_bucketing.make_bucket_layout(
            ref_leaves, ref_comp.make_plan("none", ref_leaves)))
    assert sorted(moved) == sorted(ref_moved)
    for k, v in moved.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_moved[k]))
    assert any(v.any() for v in moved.values()) and any(
        not v.any() for v in moved.values())
    back = compressor.resize_compressor_state(
        moved, plan, 2, old_layout=none_layout, new_layout=layout)
    assert sorted(back) == sorted(state)


def test_from_reference_carries_wire_ef_entries():
    ef = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    q, err = _np((1, 4, 2), 1), _np((1, 3, 4), 2)
    out = interop.from_reference({"comp": {
        "ef:['x']": ef, "group:3x4:r2": ref_psgd.LowRankState(q=q, err=err)}})
    assert out["comp"]["ef:['x']"].dtype == torch.float32
    np.testing.assert_array_equal(out["comp"]["ef:['x']"].numpy(), ef[0])
    assert isinstance(out["comp"]["group:3x4:r2"], powersgd.LowRankState)
    np.testing.assert_array_equal(out["comp"]["group:3x4:r2"].q.numpy(), q[0])


def test_quant8_payload_bound_is_the_ledger():
    """coded_bytes prices exactly the words pack_words makes, plus one fp32
    scale per group."""
    for mode in ("quant8", "quant4"):
        codec = wire.resolve_codec(mode)
        for n in (1, 1023, 1025, 50_000):
            codes, scales = wire.quantize(torch.from_numpy(_np((n,), n)), codec)
            words = pack.pack_words(codes, codec.bits)
            assert wire.coded_bytes(n, codec) == 4 * (words.numel()
                                                      + scales.numel())
            assert scales.numel() == math.ceil(n / codec.group)


# ------------------------------------------------- the guard under a coding
def _fault_pair(wire_mode: str, steps: int):
    """(reference, port) trainers on a 2-layer model with a NaN gradient at
    step 3, the guard on and rollback off; the port starts from the
    reference's state. The reference runs on a 1 x 1 Auto-axis mesh."""
    model = dict(name="el", family="dense", num_layers=2, d_model=128,
                 num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)
    kw = dict(policy="fixed", fixed_rank=8, total_iterations=steps)
    tkw = dict(total_steps=steps, log_every=1)
    rsync, psync = RefSyncConfig(wire=wire_mode), SyncConfig(wire=wire_mode)
    ref = RefTrainer(
        ref_build_model(RefModelConfig(**model)),
        Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
             axis_types=(AxisType.Auto,) * 2),
        RefEDGCConfig(sync=rsync, **kw),
        RefTrainerConfig(faults=ref_parse_inject("nan_grad@3"),
                         recovery=RefRecoveryConfig(rollback=False),
                         sync=rsync, adam=RefAdamConfig(lr=1e-3),
                         **tkw), seed=0)
    port = Trainer(
        build_model(ModelConfig(**model)),
        EDGCConfig(sync=psync,
                   hw=HardwareSpec(**dataclasses.asdict(ref_comm.TPU_V5E)),
                   **kw),
        TrainerConfig(faults=parse_inject("nan_grad@3"),
                      recovery=RecoveryConfig(rollback=False), sync=psync,
                      adam=AdamConfig(lr=1e-3), **tkw),
        seed=0, device="cpu")
    port.state = interop.from_reference(jax.device_get(ref.state))
    return ref, port


@pytest.mark.parametrize("wire_mode,skips", [("raw", 1), ("quant8", 0)])
def test_coded_wire_hides_a_nan_gradient_from_the_guard_as_the_reference(
        wire_mode, skips):
    """A defect of the reference that the port shares, on purpose: under a
    coded wire the non-finite guard never trips. ``quantize`` takes scale
    1 for a NaN group (``amax > 0`` is false) and casts its NaN codes to
    0, so the payload every worker receives is finite (-qmax per element)
    and the NaN stays only in the wire's EF residual. Under the raw wire
    the same fault is skipped. Both packages give the same recovery
    counters (the EMA within 5e-3)."""
    steps = 6
    ref, port = _fault_pair(wire_mode, steps)
    rd = RefSyntheticLM(vocab_size=512, seq_len=64, batch_size=4,
                        seed=0).batches()
    pd = SyntheticLM(vocab_size=512, seq_len=64, batch_size=4,
                     seed=0).batches()
    for _ in range(steps):
        resets = ref.recovery.ef_resets
        ref.run(rd, num_steps=1)
        port.run(pd, num_steps=1)
        if ref.recovery.ef_resets != resets:   # fresh jax.random warm starts
            port.state["comp"] = interop.from_reference(
                {"comp": jax.device_get(ref.state["comp"])})["comp"]
    got, want = port.recovery.as_dict(), ref.recovery.as_dict()
    assert want["skipped_steps"] == want["ef_resets"] == skips
    assert got.pop("loss_ema") == pytest.approx(want.pop("loss_ema"),
                                                rel=5e-3)
    assert got == want
    for a, b in zip(port.history, ref.history):
        assert abs(a["loss"] - b["loss"]) < 5e-3, (a, b)
