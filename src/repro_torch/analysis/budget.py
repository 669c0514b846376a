"""Psum-budget checker: predicted against recorded collective counts.

The port's counterpart of ``repro/analysis/budget.py``. The bucketed sync
has an exact collective bill known before it runs: 2 factor all-reduces
per stacked PowerSGD shape group, 1 per flat bucket or chunk
(``BucketLayout.num_collectives`` / ``SyncChunk.num_collectives``), and on
the pipelined step the entropy's moments, which the GDS alpha gate leaves
out on entropy-off steps. This module turns those predictions into
checks:

  * :class:`CollectiveSpy`: a recording stand-in for the executors'
    ``psum_mean`` hook; :func:`spy_sync` runs ``fn(*args, spy)`` under
    ``FakeTensorMode`` (shapes only, any model size), and
    :func:`check_sync_spy` holds the record to a ``BucketLayout`` (count,
    factor/flat split, per-group ranks);
  * :func:`check_entropy_gate`: the entropy-on step's all-reduces minus
    the entropy-off step's equal the moments' count. The reference's
    pipelined step issues three pipe psums for them (n, s1, s2,
    ``repro/pipeline/schedule.py:836-838``); the port's stacks them into
    one ``(3, S)`` ``psum_pipe`` (``pipeline/executor.py``), one pipe
    all-reduce on ``DistPipe`` and none on ``LocalPipe``, so
    :data:`ENTROPY_PSUMS` is 1. The flat step measures entropy on synced
    gradients: its delta is 0 in both packages;
  * :func:`check_overlap_branches`: the overlapped executor's labelled
    launches against ``schedule.overlap_branch_psums``.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch.utils._pytree import tree_map_only

from .dispatch_log import count_collectives
from .parity import Violation, check_launch_budgets

__all__ = [
    "ENTROPY_PSUMS",
    "CollectiveSpy",
    "spy_sync",
    "check_sync_spy",
    "check_entropy_gate",
    "check_overlap_branches",
]

# The entropy moments' all-reduces the alpha gate removes on the port's
# pipelined step: one stacked (3, S) pipe all-reduce (the reference's 3)
ENTROPY_PSUMS = 1


class CollectiveSpy:
    """Recording stand-in for the executors' ``psum_mean`` hook.

    Passes values through unchanged while recording (shape, dtype) of
    every launch, on real or fake tensors. Factor psums are the 3-D
    stacked PowerSGD launches; flat psums the 1-D packed buckets or chunks;
    the 0-d calls are a step's metric means (loss, EF norm), not its sync.
    """

    def __init__(self) -> None:
        self.calls: list[tuple[tuple[int, ...], Any]] = []

    def __call__(self, x):
        def record(t: torch.Tensor) -> torch.Tensor:
            self.calls.append((tuple(t.shape), t.dtype))
            return t
        return tree_map_only(torch.Tensor, record, x)

    def __len__(self) -> int:
        return len(self.calls)

    def __bool__(self) -> bool:
        # a hook, never "no hook": the steps default a falsy psum_mean
        return True

    @property
    def factor_calls(self) -> list[tuple[tuple[int, ...], Any]]:
        return [c for c in self.calls if len(c[0]) == 3]

    @property
    def flat_calls(self) -> list[tuple[tuple[int, ...], Any]]:
        return [c for c in self.calls if len(c[0]) == 1]

    @property
    def sync_calls(self) -> list[tuple[tuple[int, ...], Any]]:
        """Every call but the 0-d metric means."""
        return [c for c in self.calls if len(c[0]) > 0]

    def factor_ranks(self) -> list[int]:
        """Distinct trailing dims of the stacked factor psums: the DAC
        ranks the executor applied on the wire."""
        return sorted({shape[-1] for shape, _ in self.factor_calls})


def spy_sync(fn, *args) -> CollectiveSpy:
    """Run ``fn(*args, spy)`` under ``FakeTensorMode`` and return the spy.

    ``fn`` takes the psum hook as its last argument (the executors'
    convention); real tensors among ``args`` are given to it as fake ones,
    so nothing is computed and any model size fits.
    """
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    spy = CollectiveSpy()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = tree_map_only(
            torch.Tensor,
            lambda t: t if isinstance(t, FakeTensor) else mode.from_tensor(t),
            args)
        fn(*fake, spy)
    return spy


def check_sync_spy(spy: CollectiveSpy, layout, where: str = "sync",
                   ) -> list[Violation]:
    """Spy record against a ``BucketLayout``'s predicted collective bill
    (a step's 0-d metric means are not counted)."""
    out: list[Violation] = []
    want = layout.num_collectives()
    n = len(spy.sync_calls)
    if n != want:
        out.append(Violation(
            rule="psum-budget", path=where,
            message=(f"executor launched {n} collectives, layout "
                     f"predicts {want} (2 per group x {len(layout.groups)} "
                     f"+ 1 per bucket x {len(layout.buckets)})")))
    nf = len(spy.factor_calls)
    if nf != 2 * len(layout.groups):
        out.append(Violation(
            rule="psum-budget", path=where,
            message=(f"{nf} stacked-factor psums, expected "
                     f"{2 * len(layout.groups)} (2 per shape group)")))
    want_ranks = sorted({g.rank for g in layout.groups})
    got_ranks = spy.factor_ranks()
    if got_ranks != want_ranks:
        out.append(Violation(
            rule="psum-budget", path=where,
            message=(f"factor psums carry ranks {got_ranks}, plan ranks "
                     f"are {want_ranks}: DAC ranks not applied on the "
                     f"wire")))
    return out


def check_entropy_gate(on: Any, off: Any,
                       expected_delta: int = ENTROPY_PSUMS,
                       where: str = "step") -> list[Violation]:
    """The alpha gate's invariant: the entropy-off step's log holds
    exactly ``expected_delta`` fewer all-reduces than the entropy-on
    step's (:data:`ENTROPY_PSUMS` for the pipelined step on ``DistPipe``,
    0 for the flat step)."""
    n_on = count_collectives(on, "all-reduce")
    n_off = count_collectives(off, "all-reduce")
    if n_on - n_off != expected_delta:
        return [Violation(
            rule="entropy-gate", path=where,
            message=(f"entropy-on launches {n_on} all-reduces, entropy-off "
                     f"{n_off}: delta {n_on - n_off}, the gate requires "
                     f"exactly {expected_delta}"))]
    return []


def declared_launches(oplan, splans) -> dict[tuple[int, int], int]:
    """``{(tick, stage): all-reduces}`` the overlap plan declares: its
    in-loop launches and, at tick -1, what runs after the loop."""
    from repro_torch.pipeline.schedule import overlap_branch_psums

    in_loop, residual = overlap_branch_psums(oplan, splans)
    want = {(t, s): n for t, counts in in_loop for s, n in enumerate(counts)}
    want.update({(-1, s): n for s, n in enumerate(residual)})
    return want


def check_overlap_branches(log: Any, oplan, splans) -> list[Violation]:
    """The overlapped step's labelled launches against the planner's
    declared schedule (``pipeline.schedule.overlap_branch_psums``).

    ``log`` is one rank's log, or ``{rank: log}``: each rank is held to
    the launches of the stages it hosts, its findings prefixed with its
    rank.
    """
    want = declared_launches(oplan, splans)
    if not isinstance(log, Mapping):
        return check_launch_budgets(log, want)
    out = []
    for rank in sorted(log):
        out.extend(Violation(v.rule, f"rank={rank}/{v.path}", v.message)
                   for v in check_launch_budgets(log[rank], want))
    return out
