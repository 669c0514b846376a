"""The harness finds cells, mixes, layouts and metrics by name: a new cell
and a new per-layer metric are files and entries, and nothing else."""
from __future__ import annotations

import json
import shutil

from bench import catalog
from conftest import run_tiny

METRIC = '''"""A throwaway metric: the window's steps."""
UNIT, LAYER, MOVES = "steps", "host loop", "tokens_per_s"


def read(rec):
    return float(rec.window_steps)
'''


def test_new_cell_and_metric_by_files_alone(tiny_root, tmp_path):
    root = tmp_path / "bench"
    shutil.copytree(tiny_root, root)
    (root / "workloads" / "throwaway.cell.json").write_text(json.dumps(
        {"config": "tiny-qwen", "traffic": "tiny.flat.r64", "chips": 1}))
    shutil.copy(root / "limits" / "tiny-qwen.flat.r64.json",
                root / "limits" / "throwaway.cell.json")
    (root / "metrics" / "throwaway.window_steps.py").write_text(METRIC)
    spec = catalog.benchmark()
    spec["per_layer"].append({"name": "throwaway.window_steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "host loop", "moves": "tokens_per_s",
                              "workloads": ["throwaway.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = catalog.cell("throwaway.cell", root)
    assert cell.model["num_kv_heads"] == 2 and cell.mix["layout"] == "flat"
    readers = catalog.metric_readers(spec, "throwaway.cell", root)
    assert list(readers) == ["throwaway.window_steps"]

    traced = run_tiny(root, "throwaway.cell", trace=True, repo=tmp_path)
    assert traced["metrics"]["throwaway.window_steps"]["value"] == traced["attempted"]
    plain = run_tiny(root, "throwaway.cell", repo=tmp_path)
    assert set(plain["metrics"]) == {"tokens_per_s", "peak_mem_gib", "setup_s"}


def test_every_benchmark_entry_has_its_files():
    spec = catalog.benchmark()
    for w in spec["workloads"]:
        cell = catalog.cell(w["name"])
        assert (cell.config, cell.traffic, cell.chips) == (w["config"], w["traffic"], w["chips"])
        assert cell.limits and set(cell.limits) <= {"loss_gap", "entropy_gap", "grad_norm_gap",
                                                    "change_gap", "change_gap_worst"}
    for c in spec["configs"]:
        data = json.loads((catalog.REPO / c["file"]).read_text())
        assert sorted(data["reduced"]) == sorted(c["reduced"])
    for m in spec["per_layer"]:
        mod = catalog.load_module("metrics", m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])
