"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload gpt2-2.5b.flat.r64 --seed 12345 \\
        --seconds 10 --trace 0

Needs CUDA and as many cards as the cell asks for; exits non-zero with no
result otherwise. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number the output
comparison read beside its limit); the same numbers close standard error.
A cell of several processes (one a card) is started from here: this
process picks a free port, starts them, relays rank 0's result, and ends
them all if one fails or none finishes its first steps in time.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CACHE = REPO / "build" / "bench_cache"
# every build and kernel cache of the run inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(var, str(CACHE / sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path[:0] = [str(REPO), str(REPO / "src")]

RANK_ENV, WORLD_ENV, PORT_ENV, T0_ENV = ("EDGC_BENCH_RANK", "EDGC_BENCH_WORLD",
                                         "EDGC_BENCH_PORT", "EDGC_BENCH_T0")
RUN_LIMIT_S = 345         # a run of several processes is ended after this


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 3):
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def finish(result: dict) -> None:
    """Print the result line, unless the JAX stack was loaded."""
    from bench.harness import forbidden_modules
    bad = forbidden_modules()
    if bad:
        fail(f"modules of the JAX package or its stack were loaded: {bad}", 4)
    print(json.dumps(result), flush=True)


def child(args) -> None:
    """One process of a run over several cards."""
    import torch
    import torch.distributed as dist
    from bench import harness
    rank, world = int(os.environ[RANK_ENV]), int(os.environ[WORLD_ENV])
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{os.environ[PORT_ENV]}",
                            world_size=world, rank=rank,
                            device_id=torch.device("cuda", rank))
    try:
        result = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                                 rank=rank, world=world, t_start=float(os.environ[T0_ENV]))
    finally:
        dist.destroy_process_group()
    if result is not None:
        finish(result)


def launch(args, world: int, limit: float) -> None:
    """Start ``world`` processes, one a card; relay rank 0's result. The
    port's kernels are built here first, once, not by every process."""
    from bench import harness
    from repro_torch.kernels import build
    t_start = time.time() - harness.process_age()
    build.build_all()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, done = [], threading.Event()
    for r in range(world):
        env = dict(os.environ, **{RANK_ENV: str(r), WORLD_ENV: str(world),
                                  PORT_ENV: str(port), T0_ENV: repr(t_start)})
        procs.append(subprocess.Popen([sys.executable, __file__] + sys.argv[1:], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))

    def relay(r, p):
        for line in p.stderr:
            if harness.FIRST_STEPS_DONE in line:
                done.set()
            sys.stderr.write(f"[rank {r}] {line}")
    threads = [threading.Thread(target=relay, args=(r, p), daemon=True)
               for r, p in enumerate(procs)]
    for t in threads:
        t.start()
    outs = [None] * world

    def drain(r, p):
        outs[r] = p.stdout.read()
    readers = [threading.Thread(target=drain, args=(r, p), daemon=True)
               for r, p in enumerate(procs)]
    for t in readers:
        t.start()
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs):
                fail(f"a process of the run exited with "
                     f"{next(rc for rc in rcs if rc not in (None, 0))}", 5)
            if all(rc == 0 for rc in rcs):
                break
            if not done.is_set() and time.time() - t_start > limit:
                fail(f"no process finished its first steps within {limit:.0f} s", 6)
            if time.time() - t_start > RUN_LIMIT_S:
                fail(f"the run did not end within {RUN_LIMIT_S} s", 6)
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in threads + readers:
            t.join(timeout=5)
    lines = (outs[0] or "").strip().splitlines()
    if not lines:
        fail("rank 0 printed no result", 7)
    finish(json.loads(lines[-1]))


def main(argv=None) -> None:
    args = parse(argv)
    if RANK_ENV in os.environ:
        return child(args)
    import torch
    from bench import catalog, harness
    cell = catalog.cell(args.workload)
    if not torch.cuda.is_available():
        fail("CUDA is not available: this benchmark measures the port on NVIDIA cards")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} visible")
    world = cell.layout.processes(cell.mix)
    if world > 1:
        return launch(args, world, float(cell.mix.get("first_step_limit_s", 240)))
    finish(harness.execute(args.workload, args.seed, args.seconds, bool(args.trace)))


if __name__ == "__main__":
    main()
