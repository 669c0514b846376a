"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
by ``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch_kernels/`` at
the root of the checkout, then loaded with ``ctypes``. Library names carry
a hash of the source, of the ``csrc/*.cuh`` headers it includes and of the
flags, so an edited source or header is rebuilt and a stale library is
never loaded; the compiler's log (``-Xptxas -v``) is kept beside each
library (``build_log``). All sources compile in parallel, one
``nvcc`` process each. A missing ``nvcc`` or a failed compile raises: there
is no fallback that would hide the kernels.

    python -m repro_torch.kernels.build     # compile everything, print logs
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "build_log", "load"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("lowrank", "pack", "flash", "flash_fwd_sm90", "flash_bwd_sm90",
           "entropy_hist")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                       " the port's CUDA kernels are compiled from source")


def _included(path: Path, seen: list[Path]) -> list[Path]:
    """``path`` and the local headers it includes (``#include "x.cuh"``),
    transitively, each once, in the order first met."""
    if path in seen:
        return seen
    seen.append(path)
    for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(),
                          re.MULTILINE):
        _included(path.parent / inc, seen)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in _included(CSRC / f"{name}.cu", []):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing; all nvcc run at once.

    Returns ``{source name: compiler log}`` for the sources built now
    (``-Xptxas -v`` puts each kernel's registers and shared memory there).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    logs, failed = {}, []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)     # atomic: a reader never sees a partial file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def build_log(name: str) -> str:
    """The compiler log of the current library of ``csrc/<name>.cu``
    (``ptxas -v``: each kernel's registers, spills and shared memory),
    building it first if need be."""
    build_all()
    return _target(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        build_all()
        _loaded[name] = ctypes.CDLL(str(_target(name)))
    return _loaded[name]


if __name__ == "__main__":
    t0 = time.perf_counter()
    for src, text in build_all().items():
        print(f"== {src}.cu\n{text}")
    print(f"built in {time.perf_counter() - t0:.2f} s -> {BUILD_DIR}")
