"""The control: the plain reference computed one precision below the
configuration's bf16, in fp8. Every product's operands are rounded to
float8 with one scale a tensor (amax over the format's largest value):
e4m3 for the forward's operands, e5m2 for the gradients in the backward,
as fp8 training recipes do; the products then run in fp32."""
from __future__ import annotations

import torch


def _q(x, dtype):
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _FP8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q(a, torch.float8_e4m3fn), _q(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q(g, torch.float8_e5m2)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        # broadcast operands (a weight against a batch) sum back to their shape
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        return ga, gb


def fp8_matmul(a, b):
    return _FP8Matmul.apply(a, b)
