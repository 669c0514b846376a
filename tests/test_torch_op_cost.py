"""The port's per-rank op counter (``repro_torch.launch.op_cost``), the
counterpart of ``repro/launch/hlo_cost.py``: FLOPs and bytes against
analytic counts, mirroring ``tests/test_hlo_cost.py`` (the Python loops
run unrolled, so no trip count is needed), the live-storage peak, and the
collective bytes by kind and across pods in a fake world of 8 ranks (a
subprocess: a fake default process group is process-global)."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.launch.op_cost import OpCounter

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _count(fn, *shapes, fake=True):
    """``fn`` on zero tensors of ``shapes`` under a counter (on fake
    tensors unless ``fake`` is False); returns (result, counter, the
    argument tensors)."""
    with FakeTensorMode() if fake else torch.no_grad():
        args = [torch.zeros(s) for s in shapes]
        c = OpCounter()
        c.track(args)
        with c:
            fn(*args)
    return c.result(), c, args


def _layers(x, w):
    for i in range(w.shape[0]):
        x = x @ w[i]
    return x


def test_plain_matmul_flops():
    r, *_ = _count(lambda a, b: a @ b, (128, 256), (256, 64))
    assert r["flops"] == 2 * 128 * 256 * 64


def test_python_layer_loop_counts_every_layer():
    """21 layers of a Python loop: 21 times one layer's product (the
    reference scales a scan body by its trip count)."""
    r, *_ = _count(_layers, (128, 256), (21, 256, 256))
    assert r["flops"] == 2 * 128 * 256 * 256 * 21


def test_nested_loops():
    def f(x, ws):
        for w2 in ws:
            x = _layers(x, w2)
        return x
    r, *_ = _count(f, (64, 64), (3, 4, 64, 64))
    assert r["flops"] == 2 * 64 * 64 * 64 * 12


def test_batched_einsum_contraction():
    r, *_ = _count(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                  (4, 32, 64), (4, 64, 16))
    assert r["flops"] == 2 * 4 * 32 * 64 * 16


def test_bytes_nonzero_and_grow_with_depth():
    b2 = _count(_layers, (64, 64), (2, 64, 64))[0]["bytes"]
    b20 = _count(_layers, (64, 64), (20, 64, 64))[0]["bytes"]
    assert b2 > 0
    assert b20 > 5 * b2
    # each layer reads h and w_i and writes h: 3 x 64 x 64 x 4 B
    assert b20 == 20 * 3 * 64 * 64 * 4


def test_views_cost_nothing():
    """Views move nothing; a reshape that must copy (of a transpose) reads
    and writes the tensor at least once."""
    r, *_ = _count(lambda a: a.view(-1)[:7].unsqueeze(0).expand(3, 7)
                  .transpose(0, 1).as_strided((2,), (1,)), (16, 16))
    assert r["flops"] == 0 and r["bytes"] == 0
    r, *_ = _count(lambda a: a.t().reshape(-1), (16, 16))
    assert r["bytes"] >= 2 * 16 * 16 * 4


def test_real_tensors_count_as_fake_ones():
    def f(x, w):
        return torch.relu(_layers(x, w)).sum()
    fake = _count(f, (32, 64), (5, 64, 64))[0]
    real = _count(f, (32, 64), (5, 64, 64), fake=False)[0]
    assert fake == real


def _propagate_tensor_meta_non_cached(fn):
    return fn()


def _propagate_through_decomp(fn):
    return fn()


# DTensor's sharding propagation: a metadata run on global shapes, and a
# decomposition traced for a strategy (on meta tensors); both run inside
# the caller's fake mode, and neither is the rank's work
PROPAGATION = {
    "tensor_meta": lambda a, b: _propagate_tensor_meta_non_cached(
        lambda: a @ b),
    "decomp": lambda a, b: _propagate_through_decomp(lambda: a @ b),
    "meta_device": lambda a, b: a.to("meta") @ b.to("meta"),
}


@pytest.mark.parametrize("case", sorted(PROPAGATION))
def test_sharding_propagation_is_not_counted(case):
    """The same product counts once when the program runs it and not at
    all when a propagation does."""
    prop = PROPAGATION[case]
    r, *_ = _count(lambda a, b: (prop(a, b), a @ b), (128, 256), (256, 64))
    assert r["flops"] == 2 * 128 * 256 * 64


@pytest.mark.parametrize("fake", [True, False], ids=["fake", "real"])
def test_live_storage_peak(fake):
    """A 1 MiB temporary made and dropped: the peak holds it on top of the
    tracked arguments, the live total drops back to them."""
    def f(a):
        t = torch.ones((256, 1024))          # 1 MiB
        return (t * 2).sum() + a.sum()
    _, c, args = _count(f, (64, 64), fake=fake)
    assert c.peak_bytes == 64 * 64 * 4 + 2 * 2**20 + 4
    assert c.live_bytes == 64 * 64 * 4
    del args                                 # the counter holds no tensor
    assert c.live_bytes == 0


# ------------------------------------------------------------ collectives
@pytest.fixture(scope="module")
def collectives():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    out = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_dryrun_jobs.py"),
                          "port_collectives"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])["port_collectives"]


# case: (bytes by kind, cross-pod bytes by kind); fp32 (4, 4) = 64 B
COLLECTIVE_CASES = {
    "all_reduce_intra": ({"all-reduce": 64}, {}),       # ranks 0-3, a pod
    "all_reduce_cross": ({"all-reduce": 64}, {"all-reduce": 64}),  # 0, 4
    "all_gather": ({"all-gather": 4 * 64}, {}),
    # DTensor: (8, 4) split over 4 ranks gathered whole; a Partial sum
    # scattered into (2, 4) rows; a split over the pod dim gathered
    "redistribute": ({"all-gather": 128}, {}),
    "reduce_scatter": ({"reduce-scatter": 32}, {}),
    "dtensor_across_pods": ({"all-gather": 64}, {"all-gather": 64}),
}


@pytest.mark.parametrize("case", sorted(COLLECTIVE_CASES))
def test_collective_bytes_by_kind_and_pod(collectives, case):
    kinds, cross = COLLECTIVE_CASES[case]
    got = collectives[case]
    assert got["collective_bytes"] == kinds
    assert {k: v for k, v in got["collective_bytes_cross"].items() if v} == cross
    assert got["flops"] == 0
    for k, v in kinds.items():
        assert got["collective_bytes_intra"].get(k, 0) == v - cross.get(k, 0)
