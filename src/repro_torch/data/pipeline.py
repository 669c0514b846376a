"""Deterministic synthetic LM stream, a byte-level file corpus and
modality stubs (port of ``SyntheticLM``, ``ByteCorpus``,
``_stub_embedding`` and ``add_modality_stubs`` in
``repro/data/pipeline.py``).

Pure numpy, copied as it is, so both packages draw bit-identical batches
from one seed: a Zipf-weighted order-2 Markov token stream with real
sequential structure, deterministic and infinitely long. Batches are numpy
``int32`` arrays; the trainer moves them to its device. The stubbed
modality frontends attach fp32 ``frames`` (audio) or ``patches`` (vision)
drawn from a generator seeded by the sha256 of ``f"{tag}:{seed}"``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterator

import numpy as np

__all__ = ["ByteCorpus", "SyntheticLM", "add_modality_stubs"]


@dataclasses.dataclass
class SyntheticLM:
    """Order-2 Markov chain with Zipf marginals, deterministic by seed."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.3

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        # Zipf-ish marginal
        ranks = np.arange(1, V + 1, dtype=np.float64)
        base = 1.0 / ranks ** self.zipf_a
        base /= base.sum()
        # each (prev-token bucket) induces a different permutation of the
        # marginal — cheap stand-in for bigram structure
        self._n_buckets = 64
        self._perms = np.stack(
            [rng.permutation(V) for _ in range(self._n_buckets)])
        self._base = base
        self._rng = np.random.default_rng(self.seed + 1)

    def _sample_batch(self) -> np.ndarray:
        """Batch-vectorized sequential draw (loop over T, vector over B)."""
        B, T, V = self.batch_size, self.seq_len + 1, self.vocab_size
        cdf = np.cumsum(self._base)
        draws = self._rng.random((B, T))
        out = np.empty((B, T), np.int64)
        prev = np.zeros(B, np.int64)
        for t in range(T):
            buckets = (prev * 2654435761) % self._n_buckets
            idx = np.minimum(np.searchsorted(cdf, draws[:, t]), V - 1)
            prev = self._perms[buckets, idx]
            out[:, t] = prev
        return out

    def batches(self) -> Iterator[dict]:
        while True:
            seqs = self._sample_batch()
            yield {
                "tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32),
            }


@dataclasses.dataclass
class ByteCorpus:
    """Byte-level LM batches over a local file the caller names: 256
    byte tokens, each batch ``batch_size`` windows of ``seq_len + 1``
    bytes at starts drawn from ``np.random.default_rng(seed)``, as the
    reference draws them (nothing is downloaded or bundled)."""

    path: str
    seq_len: int
    batch_size: int
    seed: int = 0

    def __post_init__(self) -> None:
        with open(self.path, "rb") as f:
            self._data = np.frombuffer(f.read(), np.uint8).astype(np.int32)
        if len(self._data) < self.seq_len + 2:
            raise ValueError(f"{self.path} too small for "
                             f"seq_len={self.seq_len}")
        self._rng = np.random.default_rng(self.seed)

    @property
    def vocab_size(self) -> int:
        return 256

    def batches(self) -> Iterator[dict]:
        n = len(self._data) - self.seq_len - 1
        while True:
            starts = self._rng.integers(0, n, self.batch_size)
            toks = np.stack([self._data[s:s + self.seq_len + 1]
                             for s in starts])
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _stub_embedding(shape: tuple[int, ...], tag: str, seed: int) -> np.ndarray:
    """Deterministic pseudo-embedding for the stubbed modality frontends."""
    h = int.from_bytes(hashlib.sha256(f"{tag}:{seed}".encode()).digest()[:4],
                       "little")
    rng = np.random.default_rng(h)
    return rng.standard_normal(shape).astype(np.float32) * 0.1


def add_modality_stubs(batch: dict, family: str, *, audio_frames: int = 0,
                       num_patches: int = 0, d_model: int = 0,
                       seed: int = 0) -> dict:
    """Attach stub frames/patches as the brief's modality-frontend carve-out."""
    B = batch["tokens"].shape[0]
    if family == "whisper":
        batch = dict(batch)
        batch["frames"] = _stub_embedding((B, audio_frames, d_model), "audio",
                                          seed)
    elif family == "vlm":
        batch = dict(batch)
        batch["patches"] = _stub_embedding((B, num_patches, d_model),
                                           "vision", seed)
    return batch
