"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package ``repro``."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_files():
    assert len(PORT_FILES) > 20
    for module in ("obs/metrics.py", "obs/trace.py", "train/faults.py",
                   "launch/report.py", "pipeline/schedule.py",
                   "pipeline/adapters.py", "pipeline/partition.py",
                   "pipeline/sync.py", "pipeline/executor.py",
                   "launch/mesh.py", "models/moe.py", "models/vlm.py",
                   "models/ssm.py", "models/hybrid.py", "models/encdec.py",
                   "configs/xlstm_125m.py", "configs/zamba2_7b.py",
                   "configs/whisper_base.py", "optim/outer.py",
                   "train/elastic.py", "serve/engine.py", "launch/serve.py",
                   "launch/serve_decode.py", "dist/sharding.py", "dist/tp.py",
                   "launch/dryrun.py", "launch/op_cost.py",
                   "analysis/__init__.py", "analysis/dispatch_log.py",
                   "analysis/parity.py", "analysis/budget.py",
                   "analysis/hostcalls.py", "analysis/lint.py",
                   "launch/audit.py"):
        assert ROOT / "src" / "repro_torch" / module in PORT_FILES
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
