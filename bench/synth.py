"""The token stream of a traffic mix: a copy of the port's ``SyntheticLM``.

An order-2 Markov chain with Zipf marginals, deterministic by seed (the
arithmetic of ``repro_torch.data.pipeline.SyntheticLM``, copied so that a
later change to the program cannot change the yardstick). The whole pool
of a run is drawn in one pass over the sequence, vectorised over every
row of every batch, and moved to the device in set-up, so the host draws
nothing inside the measured window.
"""
from __future__ import annotations

import numpy as np
import torch


def token_rows(vocab: int, seq: int, rows: int, seed: int,
               zipf_a: float = 1.3) -> np.ndarray:
    """``rows`` sequences of ``seq + 1`` tokens (int64)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    base = 1.0 / ranks ** zipf_a
    base /= base.sum()
    n_buckets = 64
    perms = np.stack([rng.permutation(vocab) for _ in range(n_buckets)])
    draws = np.random.default_rng(seed + 1).random((rows, seq + 1))
    cdf = np.cumsum(base)
    out = np.empty((rows, seq + 1), np.int64)
    prev = np.zeros(rows, np.int64)
    for t in range(seq + 1):
        buckets = (prev * 2654435761) % n_buckets
        idx = np.minimum(np.searchsorted(cdf, draws[:, t]), vocab - 1)
        prev = perms[buckets, idx]
        out[:, t] = prev
    return out


def pool(vocab: int, mix: dict, seed: int, device) -> list[dict]:
    """``mix["pool"]`` distinct global batches (``batch`` rows a replica
    times ``replicas``), each ``{"tokens", "labels"}`` int64 on ``device``."""
    rows = mix["batch"] * mix.get("replicas", 1)
    seqs = torch.from_numpy(token_rows(vocab, mix["seq"], rows * mix["pool"],
                                       seed, mix.get("zipf_a", 1.3)))
    seqs = seqs.to(device)
    return [{"tokens": seqs[i * rows:(i + 1) * rows, :-1].contiguous(),
             "labels": seqs[i * rows:(i + 1) * rows, 1:].contiguous()}
            for i in range(mix["pool"])]
