"""Record the profiler fixture of ``test_bench_counts.py`` on a card.

    python3 bench/tests/record_trace_fixture.py bench/tests/fixtures/two_streams.trace.json

Products and elementwise kernels on the default stream, a spinning kernel
on a side stream beside some of them, and idle gaps, traced by
``torch.profiler`` (CUDA activity only, as the harness traces) and kept
trimmed to the kernel and CUDA runtime and driver events.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile


def main(out: str) -> None:
    a = torch.randn(2048, 2048, device="cuda")
    b = torch.randn(2048, 2048, device="cuda")
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(6):
            if i % 2 == 0:
                with torch.cuda.stream(side):
                    torch.cuda._sleep(1_000_000)
            c = a @ b
            c.add_(1.0).mul_(0.5)
            torch.cuda.synchronize()
            torch.cuda._sleep(200_000)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    keep = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "cuda_runtime", "cuda_driver")]
    with open(out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(), "traceEvents": keep}, f)
    print(f"{len(keep)} events to {out}")


if __name__ == "__main__":
    main(sys.argv[1])
