"""Collective-parity checker: deadlock freedom across the ranks of a group.

The port's counterpart of ``repro/analysis/parity.py``. The reference runs
one SPMD program on every rank and proves, on the traced jaxpr, that every
``lax.switch`` whose branches launch different collectives branches on a
predicate uniform over those collectives' axes. The port's pipeline is
MPMD: each rank runs its own stage program, and the overlapped executor
launches a stage's sync chunks at ticks of its own. What must hold is the
property the proof stands for: every member of a process group issues the
same collectives on that group in the same order, or a rank blocks in a
collective its peer never enters.

:func:`check_collective_parity` checks it on the recorded logs of the ranks
the audit ran (``analysis.dispatch_log``), group by group, and pairs every
send with its receive. It sees the runs it is given: unlike the
reference's walk, it proves nothing about inputs it did not run.

Where a launch schedule is declared (``schedule.overlap_branch_psums``),
:func:`check_launch_budgets` diffs each launch's collective count against
it, tick by tick and stage by stage: a dropped psum in one launch is not a
deadlock (the data group still agrees) but a silently unsynced gradient
chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from .dispatch_log import P2P_KINDS, CollectiveCall, _calls

__all__ = [
    "Violation",
    "check_collective_parity",
    "launch_collective_counts",
    "check_launch_budgets",
]


@dataclasses.dataclass(frozen=True)
class Violation:
    """One auditor finding, path-qualified into the recorded step."""

    rule: str
    path: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.path}: {self.message}"


def _where(c: CollectiveCall) -> str:
    at = f" at {c.path}" if c.path else ""
    if c.label is not None:
        at += f" (tick {c.label[0]}, stage {c.label[1]})"
    return at


def _diff_detail(ref: list, other: list, ra: int, rb: int) -> str:
    n = min(len(ref), len(other))
    for k in range(n):
        if not ref[k].matches(other[k]):
            return (f"first divergence at collective #{k}: rank {ra} issues "
                    f"{ref[k].describe()}{_where(ref[k])}, rank {rb} issues "
                    f"{other[k].describe()}{_where(other[k])}.")
    longer, which = (ref, ra) if len(ref) > len(other) else (other, rb)
    return (f"rank {which} issues {abs(len(ref) - len(other))} extra "
            f"collective(s) starting with {longer[n].describe()}"
            f"{_where(longer[n])} (rank {ra}: {len(ref)}, rank {rb}: "
            f"{len(other)}).")


def check_collective_parity(logs: Mapping[int, Any]) -> list[Violation]:
    """Audit the recorded logs of several ranks (``{rank: log}``) for
    collective parity.

    For every process group a log touched, each member rank that was run
    must issue the same sequence of collectives on it (point-to-point ops
    left out); each send from rank a to rank b must pair, in order, with a
    receive on b from a of the same shapes and dtypes. Returns [] when
    every group agrees, else one violation per group or rank pair, naming
    the first divergence.
    """
    calls = {int(r): _calls(log) for r, log in logs.items()}
    out: list[Violation] = []
    groups = sorted({c.group for cs in calls.values() for c in cs
                     if c.kind not in P2P_KINDS and c.group})
    for group in groups:
        members = [r for r in group if r in calls]
        seqs = {r: [c for c in calls[r]
                    if c.group == group and c.kind not in P2P_KINDS]
                for r in members}
        ra = members[0]
        for rb in members[1:]:
            a, b = seqs[ra], seqs[rb]
            if len(a) == len(b) and all(x.matches(y) for x, y in zip(a, b)):
                continue
            out.append(Violation(
                rule="collective-parity", path=f"group={list(group)}",
                message=(f"ranks {ra} and {rb} of group {list(group)} issue "
                         f"different collective sequences on it: a rank "
                         f"blocks in a collective its peer never enters "
                         f"(deadlock). {_diff_detail(a, b, ra, rb)}")))
            break
    for a in sorted(calls):
        peers = sorted({c.peer() for c in calls[a] if c.kind == "send"}
                       | {r for r in calls if any(
                           c.kind == "recv" and c.peer() == a
                           for c in calls[r])})
        for b in peers:
            if b is None or b not in calls or b == a:
                continue
            sends = [c for c in calls[a] if c.kind == "send" and c.peer() == b]
            recvs = [c for c in calls[b] if c.kind == "recv" and c.peer() == a]
            for k, (s, r) in enumerate(zip(sends, recvs)):
                if s.operands != r.operands:
                    out.append(Violation(
                        rule="collective-parity", path=f"p2p {a}->{b}",
                        message=(f"send #{k} from rank {a}{_where(s)} carries "
                                 f"{s.describe()}, the matching receive on "
                                 f"rank {b}{_where(r)} expects "
                                 f"{r.describe()}")))
                    break
            else:
                if len(sends) != len(recvs):
                    out.append(Violation(
                        rule="collective-parity", path=f"p2p {a}->{b}",
                        message=(f"rank {a} sends {len(sends)} message(s) to "
                                 f"rank {b}, which receives {len(recvs)} "
                                 f"from it: a send or a receive never "
                                 f"completes (deadlock)")))
    return out


# ----------------------------------------------------- declared-budget diff
def launch_collective_counts(log: Any, kind: str = "all-reduce",
                             ) -> tuple[tuple[tuple[int, int], int], ...]:
    """((tick, stage), collectives of ``kind``) of every labelled launch of
    a log, in launch order: the recorded side of the launch-schedule diff
    (tick -1 is the launch after the loop)."""
    labels = list(dict.fromkeys(getattr(log, "labels", ())))
    counts = {lab: 0 for lab in labels}
    for c in _calls(log):
        if c.label is not None and c.kind == kind:
            counts[c.label] = counts.get(c.label, 0) + 1
    return tuple(counts.items())


def check_launch_budgets(log: Any, expected, kind: str = "all-reduce",
                         ) -> list[Violation]:
    """Diff a log's labelled launches against the declared schedule.

    ``expected`` maps ``(tick, stage)`` to the collectives that launch
    declares (a mapping or ``((tick, stage), n)`` pairs); only the stages
    the log hosts (those its labels name) are checked. A launch whose
    recorded count disagrees, a declared launch that never ran and a launch
    the schedule does not declare each give a violation whose path names
    tick and stage.
    """
    want = dict(expected)
    got = dict(launch_collective_counts(log, kind))
    hosted = {s for _, s in got}
    out: list[Violation] = []
    for (t, s), n in sorted(want.items()):
        if s not in hosted:
            continue
        path = f"tick={t}/stage={s}"
        if (t, s) not in got:
            if n:
                out.append(Violation(
                    rule="psum-budget", path=path,
                    message=(f"no launch ran, the declared schedule expects "
                             f"{n} {kind} collective(s) there")))
            continue
        if got[(t, s)] != n:
            out.append(Violation(
                rule="psum-budget", path=path,
                message=(f"launch issues {got[(t, s)]} {kind} collectives, "
                         f"declared schedule expects {n}")))
    for (t, s), c in got.items():
        if (t, s) not in want and s in hosted:
            out.append(Violation(
                rule="psum-budget", path=f"tick={t}/stage={s}",
                message=(f"launch of {c} {kind} collective(s) that the "
                         f"declared schedule does not have")))
    return out
