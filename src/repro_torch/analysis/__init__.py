"""Collective-safety auditor: checks over recorded eager train steps.

The port's counterpart of ``repro/analysis``. The reference walks the
jaxprs ``jax.make_jaxpr`` traces; the port records what each rank of a
step launches (``dispatch_log.CollectiveLog``, a ``TorchDispatchMode``, in
a fake process group where a divergent rank cannot hang) and checks the
per-rank logs, or reads the Python source (the AST lint):

  * collective parity (`parity`): every member of a process group issues
    the same collectives on it in the same order, and every send meets its
    receive;
  * psum budgets (`budget`): predicted against recorded collective counts,
    per launch of the overlapped executor and for the entropy gate;
  * host-sync and recompile audit (`hostcalls`);
  * repo-specific AST lint rules (`lint`).

CLI entry point: ``python -m repro_torch.launch.audit``.
"""
from .dispatch_log import (
    COLLECTIVE_OPS,
    HOST_SYNC_OPS,
    CollectiveCall,
    CollectiveLog,
    HostSync,
    RankLog,
    collective_signature,
    count_collectives,
    launch_label,
)
from .parity import (
    Violation,
    check_collective_parity,
    check_launch_budgets,
    launch_collective_counts,
)
from .budget import (
    ENTROPY_PSUMS,
    CollectiveSpy,
    check_entropy_gate,
    check_overlap_branches,
    check_sync_spy,
    spy_sync,
)
from .hostcalls import (
    audit_recompiles,
    check_host_transfers,
    check_step_cache,
)
from .lint import (
    HOT_PATH_SUFFIXES,
    LINT_ROOTS,
    LintFinding,
    RULES,
    lint_source,
    run_lint,
)

__all__ = [
    "COLLECTIVE_OPS",
    "HOST_SYNC_OPS",
    "CollectiveCall",
    "CollectiveLog",
    "HostSync",
    "RankLog",
    "collective_signature",
    "count_collectives",
    "launch_label",
    "Violation",
    "check_collective_parity",
    "check_launch_budgets",
    "launch_collective_counts",
    "ENTROPY_PSUMS",
    "CollectiveSpy",
    "check_entropy_gate",
    "check_overlap_branches",
    "check_sync_spy",
    "spy_sync",
    "audit_recompiles",
    "check_host_transfers",
    "check_step_cache",
    "HOT_PATH_SUFFIXES",
    "LINT_ROOTS",
    "LintFinding",
    "RULES",
    "lint_source",
    "run_lint",
]
