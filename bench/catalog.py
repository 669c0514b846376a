"""Finding a cell's parts by name.

``workloads/<cell>.json`` names its configuration, its traffic mix and its
chips; ``configs/<config>.json`` holds the model as it is run;
``traffic/<traffic>.json`` the work (layout, policy, batch, sequence,
optimizer); ``limits/<cell>.json`` the limit of each number the output
comparison reads; ``layouts/<layout>.py`` drives the trainer;
``metrics/<metric>.py`` reads one per-layer metric. ``BENCHMARK.json`` at
the root of the checkout says which metrics a cell reports. A new cell,
mix, layout or metric is a new file: nothing here lists them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent


def load_json(kind: str, name: str, root: Path = BENCH) -> dict:
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = BENCH):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = Path(root) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    mod_name = f"bench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(repo: Path = REPO) -> dict:
    with open(Path(repo) / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    model: dict          # the ModelConfig fields, as run
    mix: dict            # the traffic mix
    limits: dict         # number compared -> its limit
    layout: object       # the layout module


def cell(name: str, root: Path = BENCH) -> Cell:
    w = load_json("workloads", name, root)
    mix = load_json("traffic", w["traffic"], root)
    return Cell(name=name, config=w["config"], traffic=w["traffic"],
                chips=int(w["chips"]),
                model=load_json("configs", w["config"], root)["model"],
                mix=mix, limits=load_json("limits", name, root),
                layout=load_module("layouts", mix["layout"], root))


def _applies(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def end_to_end(spec: dict, cell_name: str) -> list[dict]:
    return [e for e in spec["end_to_end"] if _applies(e, cell_name)]


def per_layer(spec: dict, cell_name: str) -> list[dict]:
    return [e for e in spec["per_layer"] if _applies(e, cell_name)]


def metric_readers(spec: dict, cell_name: str, root: Path = BENCH) -> dict:
    """name -> (BENCHMARK.json entry, reader module) for the cell's
    per-layer metrics."""
    return {e["name"]: (e, load_module("metrics", e["name"], root))
            for e in per_layer(spec, cell_name)}
