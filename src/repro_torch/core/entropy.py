"""GDS — Gradient Data Sampler (paper §IV-B), on torch tensors.

Port of ``repro/core/entropy.py``. Entropy is estimated from a two-level
down-sample: GSR beta (fraction of entries per measured iteration) and ISR
alpha (fraction of iterations measured; the gate lives in the controller).

  * ``gaussian_entropy`` — Lemma 2, H = log(sigma) + 0.5*log(2*pi*e); what
    CQM's Theorem 3 consumes.
  * ``histogram_entropy`` — plug-in estimator -sum p log(p / w) in plain
    torch, as the reference's trainer computes it; the histogram kernel
    is reached through ``kernels.ops.sampled_entropy_hist``.

The measurement stays on the device: ``grads_entropy`` returns a 0-d tensor
and the trainer reads it at its next flush.

Tensor parallelism: a DTensor leaf is sampled at the positions
``strided_sample`` takes from the whole leaf (``split_sample``: each
process reads the ones in its shard), and its moments are summed over the
mesh dims it is split on; no process gathers a gradient leaf. The
histogram estimator gathers the sample itself (a beta-fraction).
"""
from __future__ import annotations

import dataclasses

import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.dist import tp

__all__ = ["GDSConfig", "strided_sample", "gaussian_entropy",
           "histogram_entropy", "sample_moments", "entropy_from_moments",
           "grads_entropy", "split_sample"]

# log(2*pi*e), rounded through float32 as the reference computes it
_LOG_2PI_E = float(np.log(np.float32(2.0 * np.pi)) + np.float32(1.0))  # lint: allow(host-call-in-hot-path) import-time constant


def strided_sample(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Deterministic strided sub-sample of a flattened tensor.

    Strided (not random) so every data-parallel replica samples the same
    positions without sharing a generator.
    """
    flat = x.reshape(-1)
    if beta >= 1.0:
        return flat
    n = flat.shape[0]
    k = max(1, int(n * beta))  # lint: allow(host-call-in-hot-path) a sample size from a static shape
    stride = max(1, n // k)
    return flat[: stride * k: stride]


def split_sample(x: DTensor, beta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``strided_sample`` of the whole leaf ``x`` read from this process's
    shard: (values, owned), both over the sample's positions; a position
    outside the shard reads 0 and is not owned. The global flat positions
    ``0, stride, ...`` are mapped to global coordinates and, where every
    coordinate falls in the shard, to the shard's flat index."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    loc = x.to_local()
    shape = tuple(x.shape)
    n = math.prod(shape)
    k = n if beta >= 1.0 else max(1, int(n * beta))  # lint: allow(host-call-in-hot-path) a sample size from a static shape
    stride = 1 if beta >= 1.0 else max(1, n // k)
    lshape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    pos = torch.arange(k, device=loc.device, dtype=torch.int64) * stride
    own = torch.ones((k,), dtype=torch.bool, device=loc.device)
    lidx = torch.zeros((k,), dtype=torch.int64, device=loc.device)
    gstride, lstride = n, math.prod(lshape)
    for d in range(len(shape)):
        gstride //= shape[d]
        lstride //= max(1, lshape[d])
        c = (pos // gstride) % shape[d] - offset[d]
        own &= (c >= 0) & (c < lshape[d])
        lidx += c * lstride
    vals = loc.reshape(-1)[torch.where(own, lidx, torch.zeros_like(lidx))]
    return torch.where(own, vals.float(), torch.zeros((), device=loc.device)), own


def _sum_over_split(t: torch.Tensor, like: DTensor) -> torch.Tensor:
    """``t`` summed over the mesh dims ``like`` is split on."""
    t = t.contiguous()
    for name in tp.sharded_dims(like):
        dist.all_reduce(t, op=dist.ReduceOp.SUM,
                        group=like.device_mesh.get_group(name))
    return t


def gaussian_entropy(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Lemma 2: H(N(mu, sigma^2)) = log sigma + 1/2 log(2 pi e)  [nats]."""
    sigma = torch.std(x.float(), unbiased=False)
    return torch.log(sigma + eps) + 0.5 * _LOG_2PI_E


def histogram_entropy(x: torch.Tensor, num_bins: int = 256,
                      range_sigmas: float = 8.0,
                      eps: float = 1e-12) -> torch.Tensor:
    """Plug-in differential entropy from a fixed-width histogram [nats].

    Bins span ``mu ± range_sigmas * sigma``; H = -sum p log p + log(w).
    """
    x = x.float().reshape(-1)
    mu = torch.mean(x)
    sigma = torch.std(x, unbiased=False) + eps
    lo = mu - range_sigmas * sigma
    width = (2.0 * range_sigmas * sigma) / num_bins
    idx = torch.clamp(((x - lo) / width).to(torch.int32), 0, num_bins - 1)
    counts = torch.bincount(idx.long(), minlength=num_bins).float()
    p = counts / x.shape[0]
    plogp = torch.where(p > 0, p * torch.log(p + eps), torch.zeros_like(p))
    return -torch.sum(plogp) + torch.log(width + eps)


@dataclasses.dataclass(frozen=True)
class GDSConfig:
    """Sampling configuration (paper defaults: beta=0.25, alpha=0.1)."""

    beta: float = 0.25          # GSR: fraction of entries per measured iter
    alpha: float = 0.1          # ISR: fraction of iters measured per window
    estimator: str = "gaussian"  # "gaussian" | "histogram"
    num_bins: int = 256

    def measure_every(self) -> int:
        """GDS measures gradient entropy once every 1/alpha iterations."""
        return max(1, round(1.0 / self.alpha))

    def should_measure(self, step_in_window: int) -> bool:
        return step_in_window % self.measure_every() == 0


def _sampled_leaves(grads, cfg: GDSConfig) -> list[torch.Tensor]:
    out = []
    for l in tree.leaves(grads):
        if l.numel() <= 16:
            continue
        if isinstance(l, DTensor):
            out.append(_sum_over_split(split_sample(l, cfg.beta)[0], l))
        else:
            out.append(strided_sample(l, cfg.beta).float())
    return out


def _split_moments(leaves, cfg: GDSConfig):
    """The pooled moments of DTensor leaves: per-leaf local (count, sum,
    sum of squares), each summed over the leaf's split in one collective
    per mesh dim, then added in leaf order."""
    parts, likes = [], []
    for l in leaves:
        if isinstance(l, DTensor):
            v, own = split_sample(l, cfg.beta)
            parts += [torch.sum(own.to(torch.float32)), torch.sum(v),
                      torch.sum(v * v)]
        else:
            v = strided_sample(l, cfg.beta).float()
            parts += [torch.full((), float(v.shape[0]), device=v.device),  # lint: allow(host-call-in-hot-path) a static shape
                      torch.sum(v), torch.sum(v * v)]
        likes += [l] * 3
    sums = tp.leafwise_sums(parts, likes)
    n, s1, s2 = (sum(sums[i::3]) for i in range(3))
    return n, s1, s2


def _host_to_device(a, device) -> torch.Tensor:
    """A numpy array on ``device`` without waiting for it: a CUDA copy goes
    from pinned memory, asynchronously (a copy from pageable memory
    synchronises the stream)."""
    t = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def sample_moments(grads, cfg: GDSConfig = GDSConfig(), lead_mask=None):
    """(count, sum, sum-of-squares) of the pooled beta-sample of a tree.

    Sufficient statistics for the Gaussian estimator, and additive across
    partial trees: the pipelined step computes them per stage and sums
    over the stages.

    ``lead_mask`` (a boolean (Lmax,) live-unit vector for a stage-stacked
    tree whose leaves all lead with that dim) excludes zero-padded slots:
    the mask broadcasts over each leaf, is sampled at the same positions
    as the values, and only live samples count. Without it a ragged
    stage would pool its pad zeros and bias sigma low.
    """
    leaves = [l for l in tree.leaves(grads) if l.numel() > 16]
    if not leaves:
        z = torch.zeros(())
        return z, z, z
    if lead_mask is None and any(isinstance(l, DTensor) for l in leaves):
        return _split_moments(leaves, cfg)
    samples = [strided_sample(l, cfg.beta).float() for l in leaves]
    if lead_mask is None:
        # made on the device: a host scalar copied there would wait for it
        n = torch.full((), float(sum(s.shape[0] for s in samples)),  # lint: allow(host-call-in-hot-path) static shapes
                       device=samples[0].device)
        s1 = sum(torch.sum(s) for s in samples)
        s2 = sum(torch.sum(s * s) for s in samples)
        return n, s1, s2
    mask = _host_to_device(np.asarray(lead_mask, dtype=np.float32),  # lint: allow(host-call-in-hot-path) the stage flags are host data
                           samples[0].device)
    masks = [strided_sample(mask.reshape((-1,) + (1,) * (l.ndim - 1))
                            .expand(l.shape), cfg.beta) for l in leaves]
    n = sum(torch.sum(m) for m in masks)
    s1 = sum(torch.sum(s * m) for s, m in zip(samples, masks))
    s2 = sum(torch.sum(s * s * m) for s, m in zip(samples, masks))
    return n, s1, s2


def entropy_from_moments(n, s1, s2, eps: float = 1e-12) -> torch.Tensor:
    """Lemma 2 from pooled sufficient statistics: H = log sigma + c."""
    n = torch.clamp(n, min=1.0)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return torch.log(torch.sqrt(var) + eps) + 0.5 * _LOG_2PI_E


@torch.no_grad()
def grads_entropy(grads, cfg: GDSConfig = GDSConfig()) -> torch.Tensor:
    """Entropy of the pooled beta-sample over all leaves of a gradient tree."""
    if cfg.estimator == "histogram":
        return histogram_entropy(torch.cat(_sampled_leaves(grads, cfg)),
                                 cfg.num_bins)
    return entropy_from_moments(*sample_moments(grads, cfg))
