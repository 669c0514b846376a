"""Checkpoints of the train state: an ``.npz`` archive plus a ``.json`` manifest.

Port of ``repro/train/checkpoint.py``, in the same format, so either
package restores what the other wrote. Leaves are named by their
``keystr`` paths (``repro_torch.tree``, identical to the reference's) and
stored as numpy arrays; bf16 tensors are stored as their 16-bit patterns.
``restore`` loads into the structure of a template and puts each leaf on
the template leaf's device in its dtype.

Crash safety: both files are written to temporary paths and
``os.replace``d into place (atomic on POSIX), archive first, and the pair
is tied together by a per-save nonce stored in both. A crash between the
two renames, or a truncated archive, raises ``CheckpointError`` ("torn
checkpoint") instead of silently mixing two saves.
"""
from __future__ import annotations

import json
import os
import uuid
import warnings
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch import tree

__all__ = ["CheckpointError", "save", "read_extra", "restore"]

_NONCE_KEY = "__manifest_nonce__"


class CheckpointError(RuntimeError):
    """A checkpoint pair is missing, torn, or structurally incompatible."""


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


def save(path: str, state: Any, extra: dict | None = None) -> None:
    """Atomically write the ``path + '.npz'`` / ``path + '.json'`` pair.

    Archive first, manifest last: an interrupted save leaves either the old
    pair intact or a nonce mismatch that ``restore`` rejects.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = tree.flatten_with_path(state)
    names = [name for name, _ in flat]
    nonce = uuid.uuid4().hex

    tmp_npz = f"{path}.npz.tmp.{nonce[:8]}"
    with open(tmp_npz, "wb") as f:
        np.savez(f, **{f"leaf_{i}": _to_numpy(a) for i, (_, a) in enumerate(flat)},
                 **{_NONCE_KEY: np.array(nonce)})
    npz_bytes = os.path.getsize(tmp_npz)

    manifest = {"names": names, "extra": extra or {},
                "nonce": nonce, "npz_bytes": npz_bytes}
    tmp_json = f"{path}.json.tmp.{nonce[:8]}"
    with open(tmp_json, "w") as f:
        json.dump(manifest, f)

    os.replace(tmp_npz, path + ".npz")
    os.replace(tmp_json, path + ".json")


def _load_manifest(path: str) -> dict:
    mpath = path + ".json"
    if not os.path.exists(mpath):
        raise CheckpointError(f"no checkpoint manifest at {mpath}")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(f"corrupt checkpoint manifest {mpath}: {e}") from e
    if "names" not in manifest or "extra" not in manifest:
        raise CheckpointError(f"checkpoint manifest {mpath} is missing required "
                              f"keys (has {sorted(manifest)})")
    return manifest


def read_extra(path: str) -> dict:
    """The manifest's ``extra`` dict only, no arrays: the trainer reads the
    controller state from it first, because the plan it holds decides the
    shapes of the compressor state that ``restore`` then checks."""
    return _load_manifest(path)["extra"]


def _load_archive(path: str, manifest: dict):
    apath = path + ".npz"
    if not os.path.exists(apath):
        raise CheckpointError(f"torn checkpoint: manifest {path}.json exists "
                              f"but archive {apath} is missing")
    expect = manifest.get("npz_bytes")
    actual = os.path.getsize(apath)
    if expect is not None and actual != expect:
        raise CheckpointError(
            f"torn checkpoint: archive {apath} is {actual} bytes, manifest "
            f"recorded {expect} (truncated write or mixed save?)")
    try:
        data = np.load(apath, allow_pickle=False)
        keys = set(data.files)
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise CheckpointError(
            f"torn checkpoint: archive {apath} is unreadable: {e}") from e
    nonce = manifest.get("nonce")
    if nonce is not None and _NONCE_KEY in keys:
        if str(data[_NONCE_KEY]) != nonce:
            raise CheckpointError(
                f"torn checkpoint: archive {apath} and manifest {path}.json "
                f"come from different saves (nonce mismatch)")
    return data


def _structure_mismatch_msg(want: list[str], have: list[str]) -> str:
    missing = [n for n in want if n not in set(have)]
    unexpected = [n for n in have if n not in set(want)]
    parts = [f"checkpoint structure mismatch: expected {len(want)} leaves, "
             f"archive has {len(have)}"]
    if missing:
        parts.append("first missing from checkpoint: " + ", ".join(missing[:3]))
    if unexpected:
        parts.append("first unexpected in checkpoint: "
                     + ", ".join(unexpected[:3]))
    if not missing and not unexpected:
        i = next(i for i, (a, b) in enumerate(zip(want, have)) if a != b)
        parts.append(f"first differing leaf at index {i}: expected "
                     f"{want[i]!r}, checkpoint has {have[i]!r}")
    return "; ".join(parts)


def _to_tensor(arr: np.ndarray, like: torch.Tensor, name: str) -> torch.Tensor:
    if arr.dtype.name == "bfloat16" or (like.dtype == torch.bfloat16
                                        and arr.dtype.itemsize == 2
                                        and arr.dtype.kind in "Vu"):
        # bf16 bit patterns (this package's format, or the reference's
        # ml_dtypes bfloat16, which loads as 2-byte records without it)
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = bits.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if t.dtype != like.dtype:
        warnings.warn(f"dtype mismatch for {name}: checkpoint {t.dtype} vs "
                      f"expected {like.dtype} (coercing)", stacklevel=3)
        t = t.to(like.dtype)
    return t.to(like.device)


def restore(path: str, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (shape and dtype checked).

    A leaf whose dtype differs is coerced, with a warning naming it.
    Returns (state, extra).
    """
    manifest = _load_manifest(path)
    data = _load_archive(path, manifest)
    flat = tree.flatten_with_path(like)
    names = [name for name, _ in flat]
    if names != manifest["names"]:
        raise CheckpointError(
            _structure_mismatch_msg(names, list(manifest["names"])))
    leaves = []
    for i, (name, ref) in enumerate(flat):
        try:
            arr = data[f"leaf_{i}"]
        except KeyError as e:
            raise CheckpointError(f"torn checkpoint: archive {path}.npz is "
                                  f"missing leaf_{i} ({name})") from e
        if tuple(arr.shape) != tuple(ref.shape):
            raise CheckpointError(f"shape mismatch for {name}: checkpoint "
                                  f"{arr.shape} vs expected {tuple(ref.shape)}")
        leaves.append(_to_tensor(arr, ref, name))
    return tree.unflatten(like, leaves), manifest["extra"]
