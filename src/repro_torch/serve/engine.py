"""Batched serving engine (port of ``repro/serve/engine.py``): token-by-token
decode over a KV cache.

The engine batches independent requests and replays each prompt through
the model's single-token ``decode_step`` to fill the cache (simple and
exact; a bulk prefill that writes the cache in one pass is a later
optimisation, in the reference too), then samples greedily or at a
temperature. It runs on the current CUDA device unless given another.

The prompts go to the device once; the cache's length stays a 0-d device
tensor and ``decode_step`` writes each token's K/V into the cache in
place, so a token costs no host sync and no cache copy. Sampling at a
temperature draws Gumbel noise from a ``torch.Generator`` seeded with
``ServeConfig.seed`` on the engine's device (the reference draws from
``jax.random``, whose streams torch cannot reproduce): one seed gives the
same tokens on one device, not the reference's.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.train.trainer import resolve_device

F32 = torch.float32


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0


class Engine:
    def __init__(self, model: Model, params, cfg: ServeConfig = ServeConfig(),
                 device=None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)

    def _sample(self, logits, gen: torch.Generator):
        """Greedy: the first maximum, as ``jnp.argmax``. At a temperature:
        the Gumbel-max draw ``argmax(l / T + g)``, as
        ``jax.random.categorical`` draws."""
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=gen, dtype=F32,
                       device=logits.device)
        u = torch.clamp(u, min=torch.finfo(F32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.to(F32) / self.cfg.temperature + gumbel,
                            dim=-1)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, extra_batch: dict | None = None
                 ) -> np.ndarray:
        """prompts: (B, T_prompt) int. Returns (B, max_new_tokens) int32.

        The prompt is replayed through ``decode_step`` to build the cache.
        ``extra_batch`` is accepted, as the reference's signature has it;
        no family's decode reads it."""
        B, T = prompts.shape
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        cache = self.model.init_cache(B, T + self.cfg.max_new_tokens,
                                      device=self.device)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                               device=self.device)
        decode = self.model.decode_step
        for t in range(T):
            logits, cache = decode(self.params, cache, toks[:, t])
        tok = self._sample(logits, gen)
        out = [tok]
        for _ in range(self.cfg.max_new_tokens - 1):
            logits, cache = decode(self.params, cache, tok)
            tok = self._sample(logits, gen)
            out.append(tok)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

    @torch.inference_mode()
    def decode_benchmark(self, batch_size: int, context: int, steps: int = 8
                         ) -> float:
        """Seconds per decode step over a cache of ``context + steps + 1``
        slots (a ring of the window under ``sliding_window``), after one
        warm-up step; the clock stops after a device synchronise."""
        cache = self.model.init_cache(batch_size, context + steps + 1,
                                      device=self.device)
        tok = torch.zeros((batch_size,), dtype=torch.int64,
                          device=self.device)
        logits, cache = self.model.decode_step(self.params, cache, tok)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = self.model.decode_step(self.params, cache, tok)
        self._sync()
        return (time.perf_counter() - t0) / steps
