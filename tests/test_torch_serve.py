"""The port's serving layer (``serve.Engine``, the ``long`` configs and the
serve launchers) against the JAX reference, on the CPU."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch import tree
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve, serve_decode
from repro_torch.models.model import build_model
from repro_torch.serve import Engine, ServeConfig

from _torch_families import pair, small_torch_thread_pool  # noqa: F401


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-235b-a22b",
                                  "xlstm-125m", "zamba2-7b"])
def test_greedy_generate_equals_reference(arch):
    """The same prompts on the reference's weights: the same 10 tokens."""
    ref_cfg, cfg, ref_model, model, params_np, params = pair(
        ref_get_config(arch, "reduced"))
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 6)).astype(np.int32)
    want = RefEngine(ref_model, params_np,
                     RefServeConfig(max_new_tokens=10)).generate(prompts)
    got = Engine(model, params, ServeConfig(max_new_tokens=10),
                 device="cpu").generate(prompts)
    assert got.dtype == np.int32 and got.shape == (3, 10)
    np.testing.assert_array_equal(got, np.asarray(want))


def _engine(temperature, seed=0, arch="qwen2-0.5b"):
    cfg = get_config(arch, "reduced")
    model = build_model(cfg)
    return Engine(model, model.init(0, "cpu"),
                  ServeConfig(max_new_tokens=8, temperature=temperature,
                              seed=seed), device="cpu"), cfg


def test_temperature_sampling_is_seeded():
    eng, cfg = _engine(0.8, seed=3)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 5))
    a, b = eng.generate(prompts), eng.generate(prompts)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < cfg.vocab_size
    other, _ = _engine(0.8, seed=4)
    assert not np.array_equal(other.generate(prompts), a)
    greedy, _ = _engine(0.0)
    assert not np.array_equal(greedy.generate(prompts), a)


def test_temperature_sampling_frequencies():
    """At one logit vector, N draws at T = 0.7: each token's frequency
    within five binomial standard deviations of softmax(l / T)."""
    eng, _ = _engine(0.7)
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, 1.5])
    n = 40000
    gen = torch.Generator().manual_seed(0)
    draws = eng._sample(logits.expand(n, -1), gen)
    freq = torch.bincount(draws, minlength=6).double() / n
    p = torch.softmax(logits.double() / 0.7, dim=0)
    bound = 5 * torch.sqrt(p * (1 - p) / n)
    assert torch.all((freq - p).abs() <= bound), (freq, p)


def test_greedy_takes_the_first_maximum():
    eng, _ = _engine(0.0)
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert eng._sample(logits, None).tolist() == [1, 0]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_long_variant_equals_reference(arch):
    assert set(ARCHS) == set(REF_ARCHS)
    want = ref_get_config(arch, "long")
    got = get_config(arch, "long")
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if arch != "xlstm-125m":
        assert got.sliding_window == 8192


def test_decode_benchmark_times_a_step():
    eng, _ = _engine(0.0)
    s = eng.decode_benchmark(2, 24, steps=3)
    assert 0 < s < 10


def test_engine_runs_on_cuda_unless_told(monkeypatch):
    """No device named and no CUDA: the engine raises, it never falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b", "reduced")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--batch", "1"])


# ------------------------------------------------------------ cache aliasing
ALIAS_ARCHS = ["qwen2-0.5b", "qwen3-moe-235b-a22b", "phi-3-vision-4.2b",
               "xlstm-125m", "zamba2-7b", "whisper-base"]


@pytest.mark.parametrize("arch", ALIAS_ARCHS)
def test_decode_step_writes_the_cache_in_place(arch):
    """Every cache tensor the step returns (but the new 0-d length) is the
    tensor it was given, so no step copies the cache."""
    cfg = get_config(arch, "reduced")
    model = build_model(cfg)
    params = model.init(0, "cpu")
    cache = model.init_cache(2, 8, device="cpu")
    before = {p: (a.data_ptr(), a.clone())
              for p, a in tree.flatten_with_path(cache)}
    _, new = model.decode_step(params, cache, torch.tensor([3, 5]))
    after = dict(tree.flatten_with_path(new))
    assert set(after) == set(before)
    changed = 0
    for path, (ptr, old) in before.items():
        if path == "['len']":
            assert int(after[path]) == 1 and int(cache["len"]) == 0
            continue
        assert after[path].data_ptr() == ptr, path
        changed += not torch.equal(after[path], old)
    assert changed > 0


# ------------------------------------------------------------------ launchers
def test_serve_launcher_runs_on_cpu(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                "--new-tokens", "6", "--bench-context", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("qwen2-smoke: ") and "M params" in out[0]
    assert out[1].startswith("generated (2, 6) tokens; first row: [")
    assert out[2].startswith("decode @ context=16, batch=2: ")


def test_serve_launcher_refuses_whisper():
    with pytest.raises(SystemExit, match="serve_decode"):
        serve.main(["--arch", "whisper-base", "--device", "cpu"])


def test_serve_decode_launcher_runs_on_cpu(capsys):
    serve_decode.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("qwen2 reduced: generated (4, 16); row0=[")
    assert out[1].startswith("whisper reduced: decoded [[")
    rows = json.loads(out[1].split("decoded ")[1])
    assert len(rows) == 2 and all(len(r) == 12 for r in rows)
