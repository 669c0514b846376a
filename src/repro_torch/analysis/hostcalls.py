"""Host-sync and recompile audit.

The port's counterpart of ``repro/analysis/hostcalls.py``. Two ways a step
stops running ahead of the device:

  * **Host round trips inside the step.** Where the reference flags a
    callback traced into a jitted step, the port flags the host syncs a
    step's :class:`~repro_torch.analysis.dispatch_log.CollectiveLog`
    recorded: an op that reads a device value on the host
    (``HOST_SYNC_OPS``, a copy to the CPU) and, on CUDA, every sync that
    ``torch.cuda.set_sync_debug_mode("warn")`` reported while the step
    ran, with the op and the port's line that caused it.
    :func:`check_host_transfers` turns each into a finding.

  * **Unbounded step variants.** The trainer's ``_get_step`` cache is
    keyed ``(CompressionPlan, measure_entropy, SyncConfig)``; plans only
    change at DAC window boundaries, so after N steps the cache must hold
    at most ``(N // window + 1)`` plans x 2 entropy variants x the codecs
    seen. :func:`check_step_cache` proves the keys hashable and inside
    that bound; :func:`audit_recompiles` derives it from a live trainer
    (``Trainer.step_cache_keys``). An eager step is not compiled, but
    every variant is a step built anew.
"""
from __future__ import annotations

from typing import Any, Iterable

from .parity import Violation

__all__ = [
    "check_host_transfers",
    "check_step_cache",
    "audit_recompiles",
]


def _allowed(sync, allowed: frozenset) -> bool:
    return (sync.op in allowed or sync.path in allowed
            or f"{sync.op}@{sync.path}" in allowed)


def check_host_transfers(log: Any, allow: Iterable[str] = (),
                         ) -> list[Violation]:
    """Flag the host syncs a step's log recorded.

    ``allow`` lists syncs that are known and intended: an op name
    (``"aten._local_scalar_dense"``), a port line, or ``"op@line"``.
    Everything else is a violation with the port line that caused it (and
    the launch label it ran under).
    """
    allowed = frozenset(allow)
    out: list[Violation] = []
    for sync in getattr(log, "host_syncs", ()):
        if _allowed(sync, allowed):
            continue
        path = sync.path
        if sync.label is not None:
            path += f" (tick {sync.label[0]}, stage {sync.label[1]})"
        how = ("reported by the CUDA sync debug mode" if sync.how ==
               "sync-debug" else "reads a device value on the host")
        out.append(Violation(
            rule="host-sync", path=path,
            message=(f"{sync.op} inside the step {how}: every call is a "
                     f"device->host round-trip")))
    return out


def check_step_cache(keys: Iterable[Any], steps: int, window: int,
                     entropy_variants: int = 2,
                     codecs_seen: int | None = None) -> list[Violation]:
    """Prove the step-cache keys are hashable and window-bounded.

    ``keys`` are the trainer's ``_get_step`` cache keys (tuples of
    ``(plan, measure_entropy, sync_cfg)``); ``steps``/``window`` bound
    the number of distinct plans at ``steps // window + 1`` (the DAC
    re-plans only at window boundaries).
    """
    out: list[Violation] = []
    keys = list(keys)
    for k in keys:
        try:
            hash(k)
        except TypeError:
            out.append(Violation(
                rule="recompile", path=repr(k),
                message="unhashable step-cache key — every lookup would "
                        "miss and recompile"))
            return out
    plans = {k[0] for k in keys if isinstance(k, tuple) and k}
    if codecs_seen is None:
        codecs_seen = len({k[2] for k in keys
                           if isinstance(k, tuple) and len(k) > 2}) or 1
    plan_bound = max(1, steps) // max(1, window) + 1
    if len(plans) > plan_bound:
        out.append(Violation(
            rule="recompile", path="_step_cache",
            message=(f"{len(plans)} distinct plans after {steps} steps "
                     f"with window={window}: plans must only change at "
                     f"window boundaries (bound {plan_bound})")))
    key_bound = plan_bound * entropy_variants * max(1, codecs_seen)
    if len(keys) > key_bound:
        out.append(Violation(
            rule="recompile", path="_step_cache",
            message=(f"{len(keys)} compiled step variants after {steps} "
                     f"steps (bound {key_bound} = {plan_bound} plans x "
                     f"{entropy_variants} entropy variants x "
                     f"{codecs_seen} codecs) — recompiles are not "
                     f"window-bounded")))
    return out


def audit_recompiles(trainer) -> list[Violation]:
    """Window-bounded-recompile audit of a live Trainer."""
    steps = len(trainer.history)
    window = int(trainer.edgc_cfg.dac.window)
    return check_step_cache(trainer.step_cache_keys(), steps, window)
