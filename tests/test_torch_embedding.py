"""The token embedding's backward is deterministic on the CPU.

Advanced indexing (``table[tokens]``) backs its gradient with an
accumulating ``index_put_``, which on the CPU sums the rows of repeated
tokens in thread-scheduling order: two backward passes of the same batch
differed in the last bits, and a donated step stopped being bit-equal to
the functional one under load (``test_torch_moe.py::
test_donated_step_equals_functional_step``). ``F.embedding``'s backward
sums them in a fixed order. Each family's embedding entry (its stage
adapter's ``embed``, which the dense, VLM and Whisper flat forwards share)
runs 20 backward passes of one 8 x 512-token batch here, all bit-equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, add_modality_stubs
from repro_torch.models.model import build_model
from repro_torch.pipeline.adapters import make_adapter

ARCHS = ["gpt2", "qwen3-moe-235b-a22b", "xlstm-125m", "zamba2-7b",
         "whisper-base", "phi-3-vision-4.2b"]
PASSES = 20


@pytest.mark.parametrize("arch", ARCHS)
def test_embedding_backward_is_deterministic(arch):
    cfg = dataclasses.replace(get_config(arch, "reduced"), num_stages=1)
    model = build_model(cfg)
    adapter = make_adapter(model, 1)
    _, shared = adapter.partition_params(model.init(0, "cpu"))
    table = shared["embed"]["tok"].requires_grad_()
    raw = add_modality_stubs(
        next(SyntheticLM(cfg.vocab_size, 512, 8, seed=0).batches()),
        cfg.family, audio_frames=cfg.audio_frames,
        num_patches=cfg.num_patches, d_model=cfg.d_model, seed=0)
    batch = {k: torch.as_tensor(v) if np.asarray(v).dtype.kind == "f"
             else torch.as_tensor(v).long() for k, v in raw.items()}

    def embedded():
        out = adapter.embed(shared, batch)
        return out["x"] if isinstance(out, dict) else out

    gen = torch.Generator().manual_seed(1)
    cotangent = torch.randn(embedded().shape, generator=gen)
    grads = [torch.autograd.grad((embedded() * cotangent).sum(), table)[0]
             for _ in range(PASSES)]
    assert grads[0].abs().sum() > 0
    assert all(torch.equal(grads[0], g) for g in grads[1:])
