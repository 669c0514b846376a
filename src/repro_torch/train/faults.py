"""Fault injection and the recovery policy of the flat trainer.

Port of ``repro/train/faults.py``. Each failure has a name, a schedule
syntax (``--inject``) and the recovery knobs the Trainer wires against it:

  * ``nan_grad@30``          — the step-30 gradients become NaN (pre-sync).
  * ``corrupt_payload@45``   — the compressor state (Q/EF) is NaN-poisoned
                               before step 45.
  * ``torn_ckpt@50``         — the *next* checkpoint written at/after step
                               50 is truncated after the save (a crash
                               mid-write on a non-atomic path).
  * ``pod_drop:1@r2``        — pod 1 leaves before outer round 2.
  * ``pod_join@r4``          — a pod joins before outer round 4.

``@N`` schedules on the inner global step, ``@rN`` on the outer round.
The round kinds are consumed by the elastic outer loop
(``train.elastic.ElasticTrainer``), which rebuilds its pod fleet before
the round; the step kinds hit its pod 0.

Recovery (``RecoveryConfig``): a non-finite guard in the step skips the
parameter/optimizer/compressor update and reports ``skipped``; the host
resets the error-feedback state and counts the anomaly. A loss-spike
detector (EMA) rolls back to the newest intact checkpoint in the ring,
with bounded retries and a re-arm backoff. After ``fallback_after``
anomalies the controller pins the plan to uncompressed sync for the rest
of the run.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterable

import torch

from repro_torch import tree

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "RecoveryConfig",
    "RecoveryState",
    "parse_inject",
    "truncate_file",
    "poison_lowrank_state",
]

#: step-scheduled kinds hit the inner Trainer loop; round-scheduled kinds
#: the elastic outer loop's membership logic.
FAULT_KINDS = ("nan_grad", "corrupt_payload", "torn_ckpt",
               "pod_drop", "pod_join")
_ROUND_KINDS = ("pod_drop", "pod_join")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    at: int             # inner global step, or outer round for pod events
    on_round: bool      # True => ``at`` is an outer-round index
    arg: int = -1       # pod index for pod_drop (-1 = highest-index pod)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")
        if (self.kind in _ROUND_KINDS) != self.on_round:
            where = "an outer round (@rN)" if self.kind in _ROUND_KINDS \
                else "an inner step (@N)"
            raise ValueError(f"{self.kind} must be scheduled on {where}")


def parse_inject(specs: str | Iterable[str]) -> "FaultPlan":
    """Parse ``--inject`` specs: ``kind[:arg]@N`` or ``kind[:arg]@rN``.

    Accepts a comma-separated string or an iterable of specs.
    """
    if isinstance(specs, str):
        specs = [s for s in specs.split(",") if s.strip()]
    events = []
    for spec in specs:
        spec = spec.strip()
        try:
            head, at_s = spec.rsplit("@", 1)
        except ValueError:
            raise ValueError(f"bad --inject spec {spec!r}: expected "
                             "kind[:arg]@step or kind[:arg]@rROUND") from None
        kind, _, arg_s = head.partition(":")
        on_round = at_s.startswith("r")
        at = int(at_s[1:] if on_round else at_s)
        arg = int(arg_s) if arg_s else -1
        events.append(FaultEvent(kind=kind, at=at, on_round=on_round,
                                 arg=arg))
    return FaultPlan(events=tuple(events))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    events: tuple[FaultEvent, ...] = ()

    def __bool__(self) -> bool:
        return bool(self.events)

    def has(self, kind: str) -> bool:
        return any(e.kind == kind for e in self.events)

    def step_events(self, step: int) -> list[FaultEvent]:
        return [e for e in self.events if not e.on_round and e.at == step]

    def round_events(self, rnd: int) -> list[FaultEvent]:
        return [e for e in self.events if e.on_round and e.at == rnd]


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Recovery policy knobs; ``None`` on the trainer disables all of it."""

    guard_nonfinite: bool = True  # in-step skip of non-finite updates
    spike_factor: float = 4.0     # loss > factor * EMA  =>  anomaly
    ema_decay: float = 0.9
    spike_warmup: int = 10        # steps of EMA before the detector arms
    rollback: bool = True         # roll back to the ring on spike/NaN loss
    max_rollbacks: int = 3
    backoff_steps: int = 5        # detector re-arm distance after rollback
    fallback_after: int = 4       # anomalies before uncompressed fallback
    ckpt_ring: int = 3            # checkpoints kept for rollback


@dataclasses.dataclass
class RecoveryState:
    """Mutable recovery counters; serialized into checkpoint ``extra``."""

    skipped_steps: int = 0
    ef_resets: int = 0
    rollbacks: int = 0
    anomalies: int = 0
    fallback: bool = False
    loss_ema: float | None = None
    backoff_until: int = -1

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RecoveryState":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


# ------------------------------------------------------------------ injectors
def truncate_file(path: str, keep_frac: float = 0.5) -> None:
    """Tear a file in place (keep the leading ``keep_frac`` of its bytes).

    Models a crash mid-write for the torn-checkpoint fault; applied to the
    ``.npz`` archive after a completed save so the manifest's recorded size
    and nonce no longer match.
    """
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep_frac)))


@torch.no_grad()
def poison_lowrank_state(comp: Any) -> Any:
    """NaN-poison element 0 of the first floating compressor leaf, in place.

    Models a corrupted compressed payload: the warm-start Q and EF residual
    that next step's compression consumes are garbage, so the synced
    gradients go non-finite and the guard must trip. Leaves are visited in
    the reference's flatten order (sorted keys, then ``LowRankState``'s
    ``(q, err)``): under a coded wire the first is an ``ef:<path>``
    residual, under the raw wire the first group's ``q``. The write stays
    on the leaf's device. Returns ``comp``.
    """
    for _, leaf in tree.flatten_with_path(comp):
        if leaf.is_floating_point() and leaf.numel():
            leaf[(0,) * leaf.ndim] = float("nan")
            return comp
    raise ValueError("corrupt_payload fault: no float compressor state "
                     "to poison (is compression enabled yet?)")
