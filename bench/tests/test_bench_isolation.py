"""Nothing the benchmark runs loads the JAX package or its stack, and the
reference loads nothing of the port (top-level module names compared
whole: the port's name begins with the JAX package's)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_after(code: str) -> set[str]:
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "src")]))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True,
                         text=True, check=True, cwd=str(REPO))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_layouts_metrics_and_reference_load_no_jax():
    code = ("from bench import catalog, harness, control, faults\n"
            "from bench.reference import model, train, control as c8\n"
            "import runpy; runpy.run_path('bench/run.py', run_name='bench_run')\n"
            "for kind in ('layouts', 'metrics'):\n"
            "    for f in sorted((catalog.BENCH / kind).glob('*.py')):\n"
            "        catalog.load_module(kind, f.stem)\n")
    assert not loaded_after(code) & FORBIDDEN


def test_a_run_loads_no_jax(tiny_root):
    code = (f"import sys; sys.path[:0] = [{str(BENCH / 'tests')!r}]\n"
            "from pathlib import Path\nfrom conftest import run_tiny\n"
            f"r = run_tiny(Path({str(tiny_root)!r}), 'tiny-gpt2.pipe4.overlap')\n"
            "assert r['correct']\n")
    got = loaded_after(code)
    assert "repro_torch" in got
    assert not got & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    got = loaded_after("from bench.reference import model, train, control")
    assert "repro_torch" not in got and not got & FORBIDDEN


def test_run_without_a_card_prints_no_result(tmp_path):
    """On the CPU, and in a checkout of only BENCHMARK.json and bench/,
    the command exits non-zero with nothing on standard output."""
    import shutil
    bare = tmp_path / "bare"
    shutil.copytree(BENCH, bare / "bench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", bare)
    for where in (REPO, bare):
        out = subprocess.run([sys.executable, "bench/run.py", "--workload", "gpt2-2.5b.flat.r64",
                              "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                             cwd=str(where), capture_output=True, text=True,
                             env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert out.returncode != 0 and out.stdout == "", (where, out.stderr[-500:])
