"""The plain reference against the port's CPU path at tiny widths.

Both sides run in fp32 on the same weights and rows, the port with its
plain PowerSGD path (QR), so every number the output check compares must
agree to rounding (``conftest.FP32_LIMITS``, 1e-4: sums of a few hundred
products taken in another order, about 1e-6 relative). A gap above it
means the reference and the port compute different things.
"""
from __future__ import annotations

import json
import socket

import pytest
import torch.multiprocessing as mp

from conftest import run_tiny


@pytest.mark.parametrize("cell", ["tiny-gpt2.flat.r64", "tiny-qwen.flat.r64",
                                  "tiny-gpt2.flat.none", "tiny-qwen.flat.none",
                                  "tiny-gpt2.pipe4.overlap", "tiny-qwen.pipe4.overlap"])
def test_reference_matches_port(tiny_root, cell):
    result = run_tiny(tiny_root, cell)
    for name, check in result["checks"].items():
        assert check["value"] <= check["limit"], (cell, name, check)
    assert result["correct"]


def _dp_worker(rank: int, world: int, port: int, root: str, out: str, fault) -> None:
    import torch.distributed as dist
    from bench import faults
    from conftest import run_tiny
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        got = run_tiny(__import__("pathlib").Path(root), "tiny-gpt2.dp4.r64",
                       rank=rank, world=world,
                       fault=None if fault is None else faults.FAULTS[fault])
    finally:
        dist.destroy_process_group()
    if got is not None:
        with open(out, "w") as f:
            json.dump(got, f)


def run_dp(root, tmp_path, fault=None) -> dict:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / f"dp_{fault}.json")
    mp.start_processes(_dp_worker, args=(2, port, str(root), out, fault), nprocs=2,
                       join=True, start_method="spawn")
    with open(out) as f:
        return json.load(f)


def test_reference_matches_port_over_gloo_data_2(tiny_root, tmp_path):
    """Two gloo processes on a ``data 2`` mesh: the DP mean of the factors
    and buckets, each replica's EF, against the reference's two replicas."""
    result = run_dp(tiny_root, tmp_path)
    for name, check in result["checks"].items():
        assert check["value"] <= check["limit"], (name, check)
    assert result["correct"]
