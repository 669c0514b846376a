"""The two training examples and the reference's last public functions.

``launch/quickstart.py`` and ``launch/train_gpt2_edgc.py`` (ports of
``examples/quickstart.py`` and ``examples/train_gpt2_edgc.py``) at a few
steps on the CPU against the reference's ``Trainer`` built with the same
configs on a 1 x 1 Auto-axis mesh (the reference examples' own
``make_host_mesh()`` gives Explicit axes under jax 0.9, on which its
trainer fails), weights carried across with ``from_reference``, at
``tests/test_torch_trainer.py``'s bars: plan and stage ranks equal step by
step, losses within 5e-3, bytes and ``comm_savings()`` equal. The DAC
window is cut to 2 steps so that the few steps reach window ends (the
warm-up ends where the entropy falls enough, as in the reference; a
re-plan's fresh warm starts come from each framework's own generator, so
they are copied across). The reference's comm model prices a TPU v5e and
the port's an H100 by default, so the examples' ``EDGCConfig`` is given
the reference's ``HardwareSpec`` here, as ``tests/test_torch_trainer.py``
gives it.

Then ``ByteCorpus``, ``make_dp_psum`` at world 1 (over two processes in
``tests/test_torch_pod_mesh.py``), ``grads_entropy_per_leaf``,
``grads_entropy_per_group`` and ``grad_std`` against the reference on the
same numpy inputs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh

from repro.configs.gpt2 import GPT2_FIDELITY as REF_FIDELITY
from repro.core import EDGCConfig as RefEDGCConfig
from repro.core import GDSConfig as RefGDSConfig
from repro.core import comm_model as ref_comm
from repro.core import entropy as ref_entropy
from repro.core.dac import DACConfig as RefDACConfig
from repro.data.pipeline import ByteCorpus as RefByteCorpus
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.dist.collectives import make_dp_psum as ref_make_dp_psum
from repro.models.model import build_model as ref_build_model
from repro.optim.adam import AdamConfig as RefAdamConfig
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig

from repro_torch import tree
from repro_torch.core import EDGCConfig, GDSConfig, grads_entropy_per_leaf
from repro_torch.core.comm_model import HardwareSpec
from repro_torch.core.entropy import grad_std, grads_entropy_per_group
from repro_torch.data.pipeline import ByteCorpus
from repro_torch.dist.collectives import make_dp_psum
from repro_torch.interop import from_reference
from repro_torch.launch import quickstart, train_gpt2_edgc

STEPS = 4
WINDOW = 2


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _ref_trainer(policy, log_every, warmup, seed_data):
    """The example's settings in the reference package (``seed_data``: the
    example's SyntheticLM keywords)."""
    devs = np.array(jax.devices()[:1]).reshape(1, 1)
    mesh = Mesh(devs, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    edgc = RefEDGCConfig(
        policy=policy, num_stages=4, total_iterations=STEPS,
        gds=RefGDSConfig(alpha=0.5, beta=0.25),
        dac=RefDACConfig(window=WINDOW, adjust_limit=4))
    tcfg = RefTrainerConfig(total_steps=STEPS, log_every=log_every,
                            adam=RefAdamConfig(lr=1e-3, warmup_steps=warmup,
                                               total_steps=STEPS))
    tr = RefTrainer(ref_build_model(REF_FIDELITY), mesh, edgc, tcfg)
    data = RefSyntheticLM(vocab_size=REF_FIDELITY.vocab_size, seq_len=128,
                          batch_size=8, **seed_data).batches()
    return tr, data


@pytest.fixture(autouse=True)
def _reference_hardware(monkeypatch):
    """The examples' controllers price the reference's TPU v5e."""
    hw = HardwareSpec(**dataclasses.asdict(ref_comm.TPU_V5E))
    for module in (quickstart, train_gpt2_edgc):
        monkeypatch.setattr(module, "EDGCConfig",
                            functools.partial(EDGCConfig, hw=hw))


def _step_by_step(ref, ref_data, port, data) -> None:
    """Both trainers one step at a time: the same plan after every step;
    a re-plan's fresh warm starts copied from the reference."""
    port.state = from_reference(jax.device_get(ref.state))
    for _ in range(STEPS):
        ranks = ref.controller.plan.ranks
        ref.run(ref_data, num_steps=1)
        port.run(data, num_steps=1)
        assert port.controller.plan.ranks == ref.controller.plan.ranks
        if ref.controller.plan.ranks != ranks:
            port.state["comp"] = from_reference(
                {"comp": jax.device_get(ref.state["comp"])})["comp"]


def _history_match(got: list, want: list) -> None:
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for a, b in zip(got, want):
        assert abs(a["loss"] - b["loss"]) < 5e-3, (a, b)
        for key in ("ranks", "bytes_synced", "bytes_full", "stage_bytes"):
            assert a[key] == b[key], key
        assert np.isclose(a["lr"], b["lr"], rtol=1e-6)


def test_quickstart_matches_reference():
    ref, ref_data = _ref_trainer("edgc", quickstart.LOG_EVERY, 20, {})
    port = quickstart.make_trainer(steps=STEPS, window=WINDOW, device="cpu")
    assert port.leaves == [type(port.leaves[0])(*dataclasses.astuple(l))
                           for l in ref.leaves]
    _step_by_step(ref, ref_data, port, quickstart.batches())
    _history_match(port.history, ref.history)
    assert port.history[0]["ranks"] == []
    assert port.comm_savings() == pytest.approx(ref.comm_savings(), abs=1e-12)
    assert port.controller.describe() == ref.controller.describe()


def test_train_gpt2_edgc_none_run_matches_reference():
    """The baseline half: ``run`` on the example's trainer (no
    compression: nothing to copy across), its final loss and savings."""
    ref, ref_data = _ref_trainer("none", train_gpt2_edgc.LOG_EVERY, 30,
                                 {"seed": 0})
    port = train_gpt2_edgc.make_trainer("none", steps=STEPS, window=WINDOW,
                                        device="cpu")
    port.state = from_reference(jax.device_get(ref.state))
    hist = ref.run(ref_data)
    loss, saved = train_gpt2_edgc.run(port)
    _history_match(port.history, hist)
    assert abs(loss - hist[-1]["loss"]) < 5e-3
    assert saved == ref.comm_savings() == 0.0


def test_train_gpt2_edgc_edgc_run_matches_reference():
    ref, ref_data = _ref_trainer("edgc", train_gpt2_edgc.LOG_EVERY, 30,
                                 {"seed": 0})
    port = train_gpt2_edgc.make_trainer("edgc", steps=STEPS, window=WINDOW,
                                        device="cpu")
    _step_by_step(ref, ref_data, port, train_gpt2_edgc.batches())
    _history_match(port.history, ref.history)
    assert port.comm_savings() == pytest.approx(ref.comm_savings(), abs=1e-12)
    assert port.controller.describe() == ref.controller.describe()


@pytest.mark.parametrize("module", [quickstart, train_gpt2_edgc],
                         ids=["quickstart", "train_gpt2_edgc"])
def test_example_without_cuda_or_device_raises(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


def test_examples_keep_the_reference_settings():
    """The step counts and windows of the reference's examples."""
    assert (quickstart.STEPS, quickstart.WINDOW) == (200, 40)
    assert (train_gpt2_edgc.STEPS, train_gpt2_edgc.WINDOW) == (300, 50)
    tr = quickstart.make_trainer(steps=2, device="cpu")
    assert tr.edgc_cfg.dac.window == 40 and tr.edgc_cfg.gds.alpha == 0.5
    assert tr.model.config.name == "gpt2-fidelity"
    batch = next(quickstart.batches())
    assert batch["tokens"].shape == (8, 128)


# ------------------------------------------------------------ ByteCorpus
@pytest.mark.parametrize("seed", [0, 7])
def test_byte_corpus_batches_equal_reference(tmp_path, seed):
    p = tmp_path / "corpus.txt"
    p.write_bytes(bytes(np.random.default_rng(1).integers(0, 256, 5000,
                                                          dtype=np.uint8)))
    ref = RefByteCorpus(str(p), seq_len=32, batch_size=4, seed=seed)
    port = ByteCorpus(str(p), seq_len=32, batch_size=4, seed=seed)
    assert port.vocab_size == ref.vocab_size == 256
    for a, b in zip(_take(port, 5), _take(ref, 5)):
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def _take(corpus, n: int) -> list:
    it = corpus.batches()
    return [next(it) for _ in range(n)]


def test_byte_corpus_refuses_a_file_too_small(tmp_path):
    p = tmp_path / "tiny.txt"
    p.write_bytes(b"abc")
    for cls in (ByteCorpus, RefByteCorpus):
        with pytest.raises(ValueError, match="too small"):
            cls(str(p), seq_len=32, batch_size=2)


# ---------------------------------------------------------- make_dp_psum
def test_dp_psum_is_the_identity_at_world_one():
    x = {"a": torch.arange(4.0), "b": [torch.ones(2, 3)]}
    assert make_dp_psum()(x) is x
    assert ref_make_dp_psum(())(x) is x


# ----------------------------------------------- the entropy's other APIs
def _gradients(seed: int) -> dict:
    """A gradient-like tree: leaves of several scales and sizes, one under
    the 16-element floor that every estimator skips."""
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((64, 48)).astype(np.float32) * 1e-2,
            "w2": rng.standard_normal((3, 40, 20)).astype(np.float32) * 1e-3,
            "b": rng.standard_normal((300,)).astype(np.float32),
            "tiny": rng.standard_normal((4,)).astype(np.float32)}


def _pair(seed: int):
    g = _gradients(seed)
    return (tree.tree_map(torch.from_numpy, g),
            jax.tree_util.tree_map(jnp.asarray, g))


@pytest.mark.parametrize("estimator", ["gaussian", "histogram"])
@pytest.mark.parametrize("beta", [1.0, 0.25])
def test_grads_entropy_per_leaf_matches_reference(estimator, beta):
    """fp32 on both sides, held within 1e-5 of the reference's value."""
    port, ref = _pair(0)
    cfg = GDSConfig(beta=beta, estimator=estimator)
    want = float(ref_entropy.grads_entropy_per_leaf(
        ref, ref_entropy.GDSConfig(beta=beta, estimator=estimator)))
    got = float(grads_entropy_per_leaf(port, cfg))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-5)


def test_grads_entropy_per_group_matches_reference():
    groups = [_pair(s) for s in (1, 2, 3)]
    want = ref_entropy.grads_entropy_per_group([r for _, r in groups],
                                               ref_entropy.GDSConfig())
    got = grads_entropy_per_group([p for p, _ in groups], GDSConfig())
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("seed", [0, 4])
def test_grad_std_matches_reference(seed):
    port, ref = _pair(seed)
    want = float(ref_entropy.grad_std(ref))
    assert float(grad_std(port)) == pytest.approx(want, rel=1e-5)
    bf16 = tree.tree_map(lambda t: t.to(torch.bfloat16), port)
    ref16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), ref)
    assert float(grad_std(bf16)) == pytest.approx(
        float(ref_entropy.grad_std(ref16)), rel=1e-5)
