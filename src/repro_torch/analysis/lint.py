"""Repo-specific AST lint rules for the collective-safety auditor.

The port's counterpart of ``repro/analysis/lint.py``, with the same allow
syntax. The rules encode how the port keeps its step from waiting on the
host and its collectives on the right group:

  ``dup-dict-key``           duplicate literal keys in a dict display: the
                             later entry silently wins. Checked everywhere.
  ``host-call-in-hot-path``  ``.item()``, ``.tolist()``, ``.cpu()``,
                             ``.numpy()``, ``float``/``int``/``bool`` of a
                             non-literal, ``torch.cuda.synchronize`` and
                             ``np.*`` in a module whose functions run inside
                             the step: on a device tensor each makes the
                             host wait for the device. Checked in the
                             ``HOT_PATH_SUFFIXES`` modules only; host-side
                             planning code there carries an inline allow.
  ``collective-group``       a ``dist.<collective>`` call without
                             ``group=``: it runs over the default group,
                             which on a ``(pipe, data, model)`` world is
                             every axis at once; every call must say which
                             group it communicates over.
  ``unhashable-cache-key``   a list/dict/set display used directly as a
                             ``*_cache`` subscript: unhashable keys turn a
                             step cache into a rebuild per step.

Allowlist format: an inline ``# lint: allow(<rule-id>)`` comment on the
offending line suppresses that rule there (add a reason after the closing
paren); ``run_lint(..., allow={rule: [path-substring, ...]})`` suppresses
a rule for whole files.
"""
from __future__ import annotations

import ast
import dataclasses
import glob
import os
import re
from typing import Iterable

__all__ = ["LintFinding", "RULES", "HOT_PATH_SUFFIXES", "LINT_ROOTS",
           "lint_source", "run_lint", "iter_py_files"]

RULES = {
    "dup-dict-key": "duplicate literal key in a dict display",
    "host-call-in-hot-path": ".item()/.tolist()/.cpu()/.numpy()/float()/"
                             "torch.cuda.synchronize/np.* in a hot-path "
                             "module",
    "collective-group": "dist collective without an explicit group=",
    "unhashable-cache-key": "unhashable literal used as a cache key",
}

# Modules whose functions run inside the step: the reference's list, and
# the two the port adds (the pipelined executor, the model axis). Host-side
# planners inside them use inline allows for those lines.
HOT_PATH_SUFFIXES = (
    "core/powersgd.py", "core/bucketing.py", "core/wire.py",
    "core/entropy.py", "pipeline/sync.py", "pipeline/schedule.py",
    "dist/collectives.py", "train/step.py", "optim/adam.py",
    "kernels/", "models/", "pipeline/executor.py", "dist/tp.py",
)

# What the port's lint covers (globs, from the repository's root)
LINT_ROOTS = ("src/repro_torch", "tests/test_torch_*.py", "chip_smoke.py")

_HOST_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_HOST_CASTS = frozenset({"float", "int", "bool"})
# torch.distributed calls that communicate over a group
_COLLECTIVE_FNS = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "broadcast", "all_to_all",
    "all_to_all_single", "send", "recv", "isend", "irecv", "barrier",
})

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([\w\-, ]+)\)")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    file: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


def _allowed_rules(line_text: str) -> frozenset[str]:
    m = _ALLOW_RE.search(line_text)
    if not m:
        return frozenset()
    return frozenset(x.strip() for x in m.group(1).split(","))


def is_hot_path(filename: str) -> bool:
    norm = filename.replace(os.sep, "/")
    return any(suffix in norm for suffix in HOT_PATH_SUFFIXES)


def _dotted(node: ast.expr) -> str:
    """``a.b.c`` of a Name/Attribute chain ('' for anything else)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


class _Visitor(ast.NodeVisitor):
    def __init__(self, filename: str, lines: list[str], hot: bool) -> None:
        self.filename = filename
        self.lines = lines
        self.hot = hot
        self.findings: list[LintFinding] = []

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 1)
        text = self.lines[line - 1] if line <= len(self.lines) else ""
        if rule in _allowed_rules(text):
            return
        self.findings.append(LintFinding(self.filename, line, rule, message))

    # -------------------------------------------------------- dup-dict-key
    def visit_Dict(self, node: ast.Dict) -> None:
        seen: dict[object, int] = {}
        for key in node.keys:
            if key is None or not isinstance(key, ast.Constant):
                continue
            try:
                marker = (type(key.value).__name__, key.value)
            except TypeError:
                continue
            if marker in seen:
                self._emit(key, "dup-dict-key",
                           f"duplicate key {key.value!r} (first at line "
                           f"{seen[marker]}) — the earlier entry is "
                           f"silently overwritten")
            else:
                seen[marker] = key.lineno
        self.generic_visit(node)

    # ------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if self.hot:
            if isinstance(func, ast.Name) and func.id in _HOST_CASTS and \
                    node.args and not isinstance(node.args[0], ast.Constant):
                self._emit(node, "host-call-in-hot-path",
                           f"{func.id}() of a tensor reads it on the host "
                           f"(a device sync)")
            elif isinstance(func, ast.Attribute) and \
                    func.attr in _HOST_METHODS:
                self._emit(node, "host-call-in-hot-path",
                           f".{func.attr}() in a hot path copies a device "
                           f"tensor to the host (a device sync)")
            elif _dotted(func) == "torch.cuda.synchronize":
                self._emit(node, "host-call-in-hot-path",
                           "torch.cuda.synchronize() inside a hot path "
                           "waits for the device")
        if isinstance(func, ast.Attribute) and \
                func.attr in _COLLECTIVE_FNS and \
                _dotted(func.value) in ("dist", "torch.distributed"):
            if not any(kw.arg == "group" for kw in node.keywords):
                self._emit(node, "collective-group",
                           f"dist.{func.attr}() without group= runs over "
                           f"the default group (every mesh axis): "
                           f"collectives must say which group they "
                           f"communicate over")
        self.generic_visit(node)

    # ------------------------------------------------ np.* in hot paths
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.hot and isinstance(node.value, ast.Name) and \
                node.value.id in ("np", "numpy"):
            self._emit(node, "host-call-in-hot-path",
                       f"np.{node.attr} in a hot path — numpy reads "
                       f"device tensors on the host")
        self.generic_visit(node)

    # ------------------------------------------------ unhashable keys
    def visit_Subscript(self, node: ast.Subscript) -> None:
        target = node.value
        name = (target.attr if isinstance(target, ast.Attribute)
                else target.id if isinstance(target, ast.Name) else "")
        if "cache" in name:
            for sub in ast.walk(node.slice):
                if isinstance(sub, (ast.List, ast.Dict, ast.Set,
                                    ast.ListComp, ast.SetComp,
                                    ast.DictComp)):
                    self._emit(node, "unhashable-cache-key",
                               f"{name}[...] indexed with an unhashable "
                               f"{type(sub).__name__.lower()} literal — "
                               f"every lookup misses and recompiles")
                    break
        self.generic_visit(node)


def lint_source(source: str, filename: str = "<string>",
                hot: bool | None = None) -> list[LintFinding]:
    """Lint one module's source; ``hot`` overrides HOT_PATH detection."""
    if hot is None:
        hot = is_hot_path(filename)
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        return [LintFinding(filename, e.lineno or 1, "dup-dict-key",
                            f"unparseable: {e.msg}")]
    v = _Visitor(filename, source.splitlines(), hot)
    v.visit(tree)
    return v.findings


def iter_py_files(roots: Iterable[str]) -> list[str]:
    """The ``.py`` files under ``roots``: files, directories (walked) and
    glob patterns."""
    out = []
    for root in roots:
        if glob.has_magic(root):
            out.extend(p for p in glob.glob(root) if p.endswith(".py"))
            continue
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                       if f.endswith(".py"))
    return sorted(out)


def run_lint(roots: Iterable[str], select: Iterable[str] | None = None,
             allow: dict[str, list[str]] | None = None,
             ) -> list[LintFinding]:
    """Lint every ``.py`` under ``roots``.

    ``select`` restricts to a rule subset (e.g. only ``dup-dict-key``
    repo-wide); ``allow`` maps rule id -> path substrings to skip.
    """
    selected = frozenset(select) if select is not None else None
    allow = allow or {}
    findings: list[LintFinding] = []
    for path in iter_py_files(roots):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        for f in lint_source(src, path):
            if selected is not None and f.rule not in selected:
                continue
            if any(sub in path for sub in allow.get(f.rule, ())):
                continue
            findings.append(f)
    return findings
