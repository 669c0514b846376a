"""The port's outer optimizer (``repro_torch.optim.outer``) against the
reference's (``repro/optim/outer.py``).

Both run three outer rounds of the same seeded per-pod deltas from the
same anchor, the reference's outer state (its warm-start Q) carried across
(``interop.outer_from_reference``): one pod in this process, two and three
pods in a subprocess over four host devices. Every collective payload is
held to the reference's pod by pod (a replaying carrier, as
``test_torch_wire.py``'s ``_Replay``: codes may flip at a quantizer
boundary, by one step, in under 0.1% of the elements, and the reference's
payload goes on so one flip cannot spread); then the synced delta, the new
anchor, the momentum, the EF, the entropy and the round's info dict agree
at the flat sync's bars, and Q up to column sign. After an edgc re-plan the
reference's resized state is copied across (fresh Q columns come from each
framework's own RNG, ROADMAP Queue 3, "warm starts")."""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_outer_ref as R
from repro.core import comm_model as ref_comm
from repro_torch import tree
from repro_torch.core import NO_COMPRESSION, make_plan, wire
from repro_torch.core.comm_model import HardwareSpec
from repro_torch.core.entropy import GDSConfig
from repro_torch.core.powersgd import LowRankState
from repro_torch.dist.collectives import PodCarrier
from repro_torch.interop import outer_from_reference, to_tensor
from repro_torch.launch.mesh import make_pod_mesh
from repro_torch.optim.outer import (OuterConfig, OuterOptimizer,
                                     make_outer_sync_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6          # the flat sync's bars (test_torch_compressor)
CASES = [(p, w) for p in R.POLICIES for w in R.WIRES]
# the reference's comm model prices a TPU v5e (the port's default is an H100)
REF_HW = HardwareSpec(**dataclasses.asdict(ref_comm.TPU_V5E))


@pytest.fixture(autouse=True)
def _small_torch_thread_pool():
    """The suite runs in several worker processes at once: a small intra-op
    pool per worker keeps them from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def _ref_proc(tmp_path_factory):
    """The two- and three-pod reference runs, started before the first test
    of the module so they run while the one-pod cases run here."""
    out = tmp_path_factory.mktemp("outer") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_outer_ref.py"),
         str(out), "2", "3"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True, scope="module")
def _start_ref(_ref_proc):
    yield


@pytest.fixture(scope="module")
def ref_runs(_ref_proc):
    proc, out = _ref_proc
    one = R.run(1)
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "REF_OUTER_OK" in stdout, \
        stdout[-3000:] + stderr[-3000:]
    with open(out, "rb") as f:
        runs = pickle.load(f)
    runs[1] = one
    return runs


def _close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol * scale)


def _close_up_to_sign(got, want, rtol=1e-4, atol=1e-4):
    """Columns (last axis) agree up to a sign per column and slice (the
    compressor tests' bar for Q)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    dots = np.sum(got * want, axis=-2, keepdims=True)
    _close(got * np.where(dots < 0, -1.0, 1.0), want, rtol, atol)


class _ReplayCarrier(PodCarrier):
    """A pod carrier whose mean holds each pod's payload to the reference
    pod's and then means the reference's payloads (see the module
    docstring); ``payloads`` are the reference's, one (N, ...) array per
    collective in call order."""

    def __init__(self, n_pods, payloads, codec):
        super().__init__(n_pods, ["cpu"] * 4)
        self.payloads, self.codec, self.calls, self.flips = payloads, codec, 0, 0

    def pmean(self, x):
        want = self.payloads[self.calls].reshape(self.n_pods, -1)
        self.calls += 1
        got = x.reshape(self.n_pods, -1).numpy()
        assert got.shape == want.shape
        for g, w in zip(got, want):
            bar = RTOL * np.abs(w) + ATOL * max(1.0, float(np.abs(w).max()))
            off = np.abs(g - w) > bar
            if self.codec is not None:
                step = float(np.abs(w).max()) / self.codec.qmax
                assert np.abs(g - w)[off].max(initial=0.0) <= step * (1 + 1e-5)
            assert off.sum() <= 1e-3 * off.size, (off.sum(), off.size)
            self.flips += int(off.sum())
        return super().pmean(torch.from_numpy(want.copy()).reshape(x.shape))


def _same_json(got, want):
    """JSON-able states equal, floats within 1e-5."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same_json(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_json(g, w)
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-5, nan_ok=True)
    else:
        assert got == want


def _tensors(t):
    return tree.tree_map(lambda a: to_tensor(a), t)


def _compare_arrays(opt, ref_arrays):
    for got, want in zip(tree.leaves(opt.momentum),
                         tree.leaves(ref_arrays["outer_m"])):
        _close(got, want)
    assert sorted(opt._comp) == sorted(ref_arrays["outer_comp"])
    for path, st in opt._comp.items():
        ref_st = ref_arrays["outer_comp"][path]
        assert tuple(st.q.shape) == ref_st.q.shape
        _close(st.err, ref_st.err)
        _close_up_to_sign(st.q, ref_st.q)


def _replanned_from_live_state(opt, live, ref_arrays):
    """A re-plan migrates the state the round's sync left (``live``): a leaf
    compressed before and after keeps its EF and the leading columns of its
    Q; a newly compressed leaf starts at zero EF. The reference migrates a
    host copy taken at its last re-plan or resize
    (``repro/optim/outer.py:211-228`` reads ``_comp_host``, which ``round``
    never refreshes), so its EF there is stale (ROADMAP Queue 3): only the
    momentum and the shapes are held to it."""
    for got, want in zip(tree.leaves(opt.momentum),
                         tree.leaves(ref_arrays["outer_m"])):
        _close(got, want)
    assert sorted(opt._comp) == sorted(ref_arrays["outer_comp"])
    for path, st in opt._comp.items():
        assert tuple(st.q.shape) == ref_arrays["outer_comp"][path].q.shape
        if path in live:
            r = min(st.q.shape[-1], live[path].q.shape[-1])
            assert torch.equal(st.err, live[path].err)
            assert torch.equal(st.q[..., :r], live[path].q[..., :r])
        else:
            assert not st.err.any()


@pytest.mark.parametrize("policy,wire_mode", CASES)
@pytest.mark.parametrize("n_pods", [1, 2, 3])
def test_outer_round_matches_reference(ref_runs, n_pods, policy, wire_mode):
    ref = ref_runs[n_pods]
    rows = ref["cases"][(policy, wire_mode)]
    params = _tensors(ref["params"])
    shapes = [tuple(a.shape) for a in tree.leaves(params)]
    opt = OuterOptimizer(params, OuterConfig(**R.ocfg_kwargs(policy, wire_mode)),
                         make_pod_mesh(n_pods, ["cpu"] * 4), 2, seed=0,
                         hw=REF_HW)
    opt.load_arrays(outer_from_reference(rows[0]["arrays"]))
    _compare_arrays(opt, rows[0]["arrays"])     # the carry-over itself
    anchor = params
    for rnd, row in enumerate(rows[1:]):
        bits = None if opt._codec is None else opt._codec.bits
        assert bits == row["codec_bits"]
        per_pod = [tree.unflatten(params, [torch.from_numpy(a) for a in ls])
                   for ls in R.deltas(shapes, n_pods, rnd)]
        # the sync step alone (its synced delta), then the round, each
        # replaying the reference's payloads
        carrier = _ReplayCarrier(n_pods, row["payloads"], opt._codec)
        opt.set_mesh(carrier)
        delta = tree.unflatten(params, [torch.stack(ds) for ds in
                                        zip(*(tree.leaves(d) for d in per_pod))])
        synced, live, h = opt._get_sync(opt.plan)(delta, opt._comp)
        assert carrier.calls == len(row["payloads"])
        for got, want in zip(tree.leaves(synced), tree.leaves(row["synced"])):
            for pod in range(n_pods):
                _close(got[pod], want)
        assert abs(float(h) - row["entropy"]) < 1e-5
        carrier.calls = 0
        anchor, info = opt.round(anchor, per_pod)
        assert carrier.calls == len(row["payloads"])
        for got, want in zip(tree.leaves(anchor), tree.leaves(row["anchor"])):
            _close(got, want)
        want_info = dict(row["info"])
        assert abs(info.pop("entropy") - want_info.pop("entropy")) < 1e-5
        assert info == want_info
        if info["plan_changed"]:
            _replanned_from_live_state(opt, live, row["arrays"])
        else:
            _compare_arrays(opt, row["arrays"])
        sd, want_sd = opt.state_dict(), row["state"]
        _same_json(sd["controller"], want_sd["controller"])
        for key in ("round_index", "n_pods", "bytes_synced", "bytes_wire_raw",
                    "bytes_full"):
            assert sd[key] == want_sd[key], key
        np.testing.assert_allclose(sd["entropy_log"], want_sd["entropy_log"],
                                   atol=1e-5)
        assert opt.comm_savings() == pytest.approx(row["comm_savings"],
                                                   abs=1e-12)
        if info["plan_changed"]:
            opt.load_arrays(outer_from_reference(row["arrays"]))
    opt.set_mesh(make_pod_mesh(n_pods, ["cpu"] * 4))


def test_pod_carrier_means_each_pods_slice():
    """The carrier means a (N, ...) or (N x L, ...) stack over its pods and
    hands every pod the mean; it refuses a stack that does not split into
    N pods and more pods than devices."""
    carrier = make_pod_mesh(2, ["cpu"] * 3)
    x = torch.arange(24, dtype=torch.float32).reshape(4, 3, 2)   # N x L = 2 x 2
    got = carrier.pmean(x)
    want = (x[:2] + x[2:]) / 2
    assert torch.equal(got, torch.cat([want, want]))
    assert torch.equal(carrier.pmean(x[:2]), (x[:1] + x[1:2]).div(2).expand(2, 3, 2))
    with pytest.raises(ValueError, match="not a multiple"):
        carrier.pmean(x[:3])
    with pytest.raises(ValueError, match="need 4 devices"):
        make_pod_mesh(4, ["cpu"] * 3)


def test_coded_pod_mean_codes_each_pod_alone():
    """A payload of 1000 elements a pod (not a multiple of the 1024-element
    quantization group): each pod's slice is coded alone, as each pod codes
    its own in the reference; coding the flat stack would put pod 1's first
    24 elements in pod 0's last group."""
    codec = wire.resolve_codec("quant8")
    carrier = make_pod_mesh(2, ["cpu"] * 2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.stack([rng.standard_normal(1000),
                                   50 * rng.standard_normal(1000)]).astype(np.float32))
    step = make_outer_sync_step(carrier, NO_COMPRESSION, GDSConfig(), codec)
    synced, _, _ = step({"w": x}, {})
    per_pod = torch.stack([wire.roundtrip_arr(r, codec) for r in x])
    assert torch.equal(synced["w"][0], per_pod.mean(0))
    assert torch.equal(synced["w"][0], synced["w"][1])
    flat = wire.roundtrip_arr(x.reshape(-1), codec).reshape(2, 1000)
    assert not torch.equal(flat.mean(0), per_pod.mean(0))


def _tiny_params():
    from repro_torch.models.model import ModelConfig, build_model
    return build_model(ModelConfig(**R.TINY)).init(0, "cpu")


def test_resize_pods_keeps_survivor_rows_and_seeds_joiners():
    """Survivors keep their Q and EF rows in the given order; a joiner gets
    the first survivor's Q and zero EF; an out-of-range survivor raises."""
    params = _tiny_params()
    opt = OuterOptimizer(params, OuterConfig(policy="fixed", fixed_rank=8),
                         make_pod_mesh(3, ["cpu"] * 4), 2)
    gen = torch.Generator().manual_seed(0)
    for st in opt._comp.values():
        st.q.copy_(torch.randn(st.q.shape, generator=gen))
        st.err.copy_(torch.randn(st.err.shape, generator=gen))
    old = {p: LowRankState(st.q.clone(), st.err.clone())
           for p, st in opt._comp.items()}
    opt.resize_pods(make_pod_mesh(2, ["cpu"] * 4), [2, 0])
    assert opt.n_pods == 2
    for p, st in opt._comp.items():
        assert torch.equal(st.q, old[p].q[[2, 0]])
        assert torch.equal(st.err, old[p].err[[2, 0]])
    opt.resize_pods(make_pod_mesh(4, ["cpu"] * 4), [1, 0])
    for p, st in opt._comp.items():
        assert st.q.shape[0] == st.err.shape[0] == 4
        assert torch.equal(st.q[:2], old[p].q[[0, 2]])
        assert torch.equal(st.q[2], old[p].q[0]) and torch.equal(st.q[3], old[p].q[0])
        assert not st.err[2:].any()
    with pytest.raises(ValueError, match="out of range"):
        opt.resize_pods(make_pod_mesh(2, ["cpu"] * 4), [4])


def test_plan_change_after_a_restore_into_a_larger_fleet():
    """Arrays saved at 2 pods, loaded into a 3-pod optimizer, then
    re-planned: the third pod takes row 0's (resized) Q and zero EF, and
    every pod draws the same new Q columns."""
    params = _tiny_params()
    small = OuterOptimizer(params, OuterConfig(policy="fixed", fixed_rank=8),
                           make_pod_mesh(2, ["cpu"] * 4), 2)
    for st in small._comp.values():
        st.err.normal_()
        st.q[1].normal_()
    big = OuterOptimizer(params, OuterConfig(policy="fixed", fixed_rank=8),
                         make_pod_mesh(3, ["cpu"] * 4), 2)
    big.load_arrays(small.arrays)
    big.controller._plan = make_plan("fixed", big.leaves, fixed_rank=12)
    big._apply_plan_change(params)
    for p, st in big._comp.items():
        old = small._comp[p]
        assert st.q.shape[0] == 3 and st.q.shape[-1] == 12
        assert torch.equal(st.q[:2, ..., :8], old.q)
        assert torch.equal(st.q[2], st.q[0])
        assert torch.equal(st.q[0, ..., 8:], st.q[1, ..., 8:])
        assert torch.equal(st.err[:2], old.err) and not st.err[2].any()


def test_state_dict_and_arrays_round_trip(tmp_path):
    """state_dict/load_state_dict and arrays/load_arrays (through a
    checkpoint pair) restore the control plane and the outer state."""
    from repro_torch.train import checkpoint as ckpt
    params = _tiny_params()
    cfg = OuterConfig(policy="fixed", fixed_rank=8, wire="quant8")
    opt = OuterOptimizer(params, cfg, make_pod_mesh(2, ["cpu"] * 2), 2)
    shapes = [tuple(a.shape) for a in tree.leaves(params)]
    for rnd in range(2):
        per_pod = [tree.unflatten(params, [torch.from_numpy(a) for a in ls])
                   for ls in R.deltas(shapes, 2, rnd)]
        params, _ = opt.round(params, per_pod)
    ckpt.save(str(tmp_path / "o"), opt.arrays, extra=opt.state_dict())
    back = OuterOptimizer(_tiny_params(), cfg, make_pod_mesh(2, ["cpu"] * 2), 2)
    extra = ckpt.read_extra(str(tmp_path / "o"))
    back.load_state_dict(extra, params)
    arrs, _ = ckpt.restore(str(tmp_path / "o"), back.arrays)
    back.load_arrays(arrs)
    assert back.state_dict() == opt.state_dict()
    for a, b in zip(tree.leaves(back.arrays), tree.leaves(opt.arrays)):
        assert torch.equal(a, b)


def test_comm_savings():
    """Savings are 1 - synced / full over the rounds run (0 before any)."""
    params = _tiny_params()
    opt = OuterOptimizer(params, OuterConfig(policy="fixed", fixed_rank=8),
                         make_pod_mesh(1, ["cpu"]), 2)
    assert opt.comm_savings() == 0.0
    shapes = [tuple(a.shape) for a in tree.leaves(params)]
    per_pod = [tree.unflatten(params, [torch.from_numpy(a) for a in ls])
               for ls in R.deltas(shapes, 1, 0)]
    opt.round(params, per_pod)
    # bench-el's per-round ledger (benchmarks/elastic_faults.py's model)
    assert (opt.bytes_synced, opt.bytes_wire_raw, opt.bytes_full) == \
        (165132, 657920, 1706496)
    assert opt.comm_savings() == pytest.approx(1 - 165132 / 1706496)
