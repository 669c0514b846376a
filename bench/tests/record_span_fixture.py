"""Record the span fixture of ``test_bench_spans.py`` on a card.

    python3 bench/tests/record_span_fixture.py bench/tests/fixtures/flat_steps.spans.json

Three flat steps of a small bf16 model (the port's ``Trainer``, the
``none`` policy as the benchmark's cells, blocks recomputed in the
backward, the entropy gate on every other step, a flush at every other
step) traced by ``torch.profiler`` with CUDA activity only, as the
harness traces, with the program's spans recorded
(``repro_torch.obs.trace.record_spans``). For the test's ground truth every
span launches a marker kernel (``torch.cuda._sleep``, a ``spin_kernel``)
right after it opens and right before it closes: the launches' correlation
ids, which the runtime hands out in issue order over every thread, then
say which span was open at each launch without any clock. Kept: the
kernel and CUDA runtime and driver events (trimmed to the fields the
attribution reads), ``baseTimeNanoseconds`` and the spans.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import EDGCConfig, GDSConfig  # noqa: E402
from repro_torch.core.dac import DACConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models.model import ModelConfig, build_model  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.optim.adam import AdamConfig  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.train import trainer as trainer_mod  # noqa: E402

MODEL = dict(name="fixture", family="dense", num_layers=2, d_model=256, num_heads=4,
             num_kv_heads=2, d_ff=1024, vocab_size=4096, max_position=256,
             dtype="bfloat16", remat=True)
DATA = dict(vocab_size=4096, seq_len=256, batch_size=4, seed=1)
STEPS = 3


def marked(name: str, **args):
    """A program span that launches a marker kernel as it opens and as it
    closes."""
    @contextlib.contextmanager
    def ctx():
        with trace.span(name, **args) as sp:
            torch.cuda._sleep(1)
            yield sp
            torch.cuda._sleep(1)
    return ctx()


def main(out: str) -> None:
    edgc = EDGCConfig(policy="none", num_stages=1, total_iterations=100,
                      gds=GDSConfig(alpha=0.5, beta=0.25),
                      dac=DACConfig(window=50, adjust_limit=4))
    tcfg = trainer_mod.TrainerConfig(
        total_steps=100, log_every=2, adam=AdamConfig(lr=1e-3, warmup_steps=1))
    tr = trainer_mod.Trainer(build_model(ModelConfig(**MODEL)), edgc, tcfg, seed=0,
                             device="cuda")
    data = SyntheticLM(**DATA).batches()
    tr.run(data, num_steps=3)
    torch.cuda.synchronize()
    step_mod.span = trainer_mod.span = marked
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with trace.record_spans() as spans:
                tr.run(data, num_steps=STEPS)
            torch.cuda.synchronize()
    finally:
        step_mod.span = trainer_mod.span = trace.span
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            obj = json.load(f)
    keep = []
    for e in obj["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "cuda_runtime", "cuda_driver"):
            continue
        a = e.get("args", {})
        args = {"correlation": a.get("correlation")}
        if e["cat"] == "kernel":
            args["stream"] = a.get("stream")
        keep.append({"ph": "X", "cat": e["cat"], "name": e.get("name", "")[:200],
                     "ts": e["ts"], "dur": e.get("dur", 0.0), "tid": e.get("tid"),
                     "args": args})
    fixture = {"device": torch.cuda.get_device_name(), "torch": torch.__version__,
               "steps": STEPS, "baseTimeNanoseconds": obj["baseTimeNanoseconds"],
               "spans": [dataclasses.asdict(s) for s in spans], "traceEvents": keep}
    with open(out, "w") as f:
        json.dump(fixture, f)
    print(f"{len(keep)} events and {len(spans)} spans to {out}")


if __name__ == "__main__":
    main(sys.argv[1])
