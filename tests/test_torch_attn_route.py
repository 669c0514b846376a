"""Which route self-attention takes (``layers.attn_route``), on the CPU.

``attn_apply`` runs the flash kernels for CUDA tensors in bf16 at a head
width in ``HEAD_DIMS`` with no sliding window, and ``blockwise_attention``
for everything else. CUDA tensors here are fake ones (``FakeTensorMode``):
they carry a device, a dtype and a shape but no memory, and take the
route the card's tensors take (the dry run's case): the flash op gives
them its outputs' shapes and its FLOP count without a kernel. The flash
branch's wiring is held to the blockwise route through the kernels' plain
versions, which the wrappers run on CPU tensors.
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.launch.op_cost import OpCounter
from repro_torch.models import layers as L

B, T = 2, 24


def _params(d_model, heads, kv_heads, dh, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = L.attn_init(gen, 1, d_model, heads, kv_heads, dh, torch.float32,
                    qkv_bias=True)
    return {k: v[0].to(dtype) for k, v in p.items()}


def _launches():
    return ({**fa.flash_fwd.launches_by_kernel,
             **fb.flash_dq.launches_by_kernel,
             **fb.flash_dkv.launches_by_kernel},
            [w.launches for w in fa.KERNELS + fb.KERNELS])


# (kind, device, dtype, head width, window, whether the card's tensors of
# this kind take the flash route)
CASES = [
    ("self", "cuda", "bfloat16", 96, 0, True),
    ("self", "cuda", "bfloat16", 128, 0, True),
    ("self", "cuda", "float32", 96, 0, False),
    ("self", "cpu", "bfloat16", 96, 0, False),
    ("self", "cpu", "float32", 128, 0, False),
    ("self", "cuda", "bfloat16", 80, 0, False),
    ("self", "cuda", "bfloat16", 128, 16, False),
    ("cross", "cpu", "float32", 64, 0, False),
]


@pytest.mark.parametrize("kind,device,dtype,dh,window,fits", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-dh{c[3]}-w{c[4]}"
                              for c in CASES])
def test_attn_route_and_counter(monkeypatch, kind, device, dtype, dh, window,
                                fits):
    """The route of each case's q, k and v (fake ones for the card, which
    route as the card's tensors do); then attn_apply (or cross_attn_apply) on CPU tensors of the case's
    dtype, width and window takes the blockwise route, counts one
    ``blockwise`` call in ``attn_apply.calls_by_route`` (cross-attention
    none), and launches no flash kernel."""
    called = []
    monkeypatch.setattr(L, "flash_attention_train",
                        lambda *a, **k: called.append(a))
    dt = getattr(torch, dtype)
    heads, kv_heads = 4, 2
    shapes = ((B, T, heads, dh), (B, T, kv_heads, dh), (B, T, kv_heads, dh))
    if device == "cuda":
        with FakeTensorMode():
            q, k, v = (torch.empty(s, dtype=dt, device="cuda") for s in shapes)
    else:
        q, k, v = (torch.randn(s).to(dt) for s in shapes)
    assert L.attn_route(q, k, v, window) == ("flash" if fits else "blockwise")

    d_model = heads * dh
    p = _params(d_model, heads, kv_heads, dh, dt)
    x = torch.randn((B, T, d_model), generator=torch.Generator().manual_seed(1)
                    ).to(dt)
    routes, launches = dict(L.attn_apply.calls_by_route), _launches()
    if kind == "self":
        out = L.attn_apply(p, x, num_heads=heads, num_kv_heads=kv_heads,
                           head_dim=dh, window=window, block_q=8)
    else:
        enc = torch.randn((B, 2 * T, kv_heads, dh)).to(dt)
        out = L.cross_attn_apply(p, x, enc, enc, num_heads=heads,
                                 num_kv_heads=kv_heads, head_dim=dh)
    assert out.shape == x.shape and out.dtype == dt
    counted = {r: n - routes[r] for r, n in L.attn_apply.calls_by_route.items()}
    assert counted == {"flash": 0, "blockwise": int(kind == "self")}
    assert _launches() == launches
    assert called == []


@pytest.mark.parametrize("heads,kv_heads,dh,causal",
                         [(4, 4, 32, True), (4, 2, 64, True), (6, 2, 96, False)])
def test_attn_apply_flash_branch_matches_blockwise(monkeypatch, heads,
                                                   kv_heads, dh, causal):
    """attn_apply's flash branch, forced on CPU tensors (the wrappers then
    run the kernels' plain versions), against its blockwise route in fp32:
    the output and the gradients of x and of every projection weight. This
    holds the branch's layout (q, k, v as (B, T, heads, Dh)), causal flag,
    GQA grouping and output reshape."""
    d_model = heads * dh
    p = _params(d_model, heads, kv_heads, dh, torch.float32, seed=2)
    x = torch.randn((B, T, d_model), generator=torch.Generator().manual_seed(3))
    grads = {}
    for route in ("blockwise", "flash"):
        monkeypatch.setattr(L, "attn_route", lambda *a, r=route: r)
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xl = x.clone().requires_grad_(True)
        before = L.attn_apply.calls_by_route[route]
        out = L.attn_apply(leaves, xl, num_heads=heads, num_kv_heads=kv_heads,
                           head_dim=dh, causal=causal, block_q=8)
        assert L.attn_apply.calls_by_route[route] == before + 1
        out.square().sum().backward()
        grads[route] = (out.detach(), xl.grad,
                        {k: v.grad for k, v in leaves.items()})
    (o_b, dx_b, dp_b), (o_f, dx_f, dp_f) = grads["blockwise"], grads["flash"]
    torch.testing.assert_close(o_f, o_b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx_f, dx_b, rtol=1e-4, atol=1e-4)
    assert dp_f.keys() == dp_b.keys() and {"wq", "wk", "wv", "wo"} <= dp_f.keys()
    for name in dp_b:
        torch.testing.assert_close(dp_f[name], dp_b[name], rtol=1e-4,
                                   atol=1e-4, msg=name)


@pytest.mark.parametrize("heads,kv_heads,dh,tk,causal",
                         [(4, 4, 96, T, True), (8, 2, 128, T, True),
                          (4, 1, 64, 2 * T, False)])
def test_flash_op_on_fake_tensors(heads, kv_heads, dh, tk, causal):
    """The flash op forward and backward on fake tensors: outputs and
    gradients of the inputs' shapes and dtypes, no kernel launched, and
    both torch's ``FlopCounterMode`` and the dry run's ``OpCounter`` count
    torch's attention FLOPs (every pair, 2 products forward, 4 backward)."""
    launches = _launches()
    with FakeTensorMode():
        q = torch.empty((B, T, heads, dh), dtype=torch.bfloat16).requires_grad_()
        k, v = (torch.empty((B, tk, kv_heads, dh), dtype=torch.bfloat16
                            ).requires_grad_() for _ in range(2))
        with FlopCounterMode(display=False) as fc, OpCounter() as oc:
            o, lse = fb._flash_op(q, k, v, causal)
            o.backward(torch.ones_like(o))
    assert o.shape == q.shape and o.dtype == q.dtype
    assert lse.shape == (B, heads, T) and lse.dtype == torch.float32
    for t in (q, k, v):
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
    pairs = B * heads * T * tk * dh
    assert fc.get_total_flops() == oc.result()["flops"] == 2 * 6 * pairs
    assert _launches() == launches


def test_attn_apply_on_fake_cuda_tensors_counts_flash():
    """attn_apply on fake CUDA tensors in bf16 at a width in HEAD_DIMS (the
    dry run's case) takes the flash route and counts it: the forward's
    FLOPs are the four projections' and the flash op's, and no kernel
    launches."""
    heads, kv_heads, dh = 4, 2, 96
    d_model, kv = heads * dh, kv_heads * dh
    routes, launches = dict(L.attn_apply.calls_by_route), _launches()
    with FakeTensorMode():
        p = {"wq": (d_model, d_model), "wk": (d_model, kv), "wv": (d_model, kv),
             "wo": (d_model, d_model)}
        p = {n: torch.empty(s, dtype=torch.bfloat16, device="cuda")
             for n, s in p.items()}
        x = torch.empty((B, T, d_model), dtype=torch.bfloat16, device="cuda")
        with FlopCounterMode(display=False) as fc:
            # no rope: a CPU build of torch cannot run it on fake CUDA
            out = L.attn_apply(p, x, num_heads=heads, num_kv_heads=kv_heads,
                               head_dim=dh, use_rope=False)
    assert out.shape == x.shape and out.is_cuda
    assert {r: n - routes[r] for r, n in L.attn_apply.calls_by_route.items()} \
        == {"flash": 1, "blockwise": 0}
    proj = 2 * B * T * d_model * (2 * d_model + 2 * kv)
    assert fc.get_total_flops() == proj + 4 * B * heads * T * T * dh
    assert _launches() == launches
