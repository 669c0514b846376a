"""Per-rank log of an eager step's collectives and host syncs.

The port's counterpart of ``repro/analysis/jaxpr_walk.py``. The reference
walks a traced jaxpr, whose collectives and callbacks it reads statically;
an eager torch step has no program to walk, so :class:`CollectiveLog`, a
``TorchDispatchMode``, records what one rank launches while the step runs
(on real tensors, or on fake ones in a fake process group, where a rank
that diverges cannot hang the others):

  * every c10d and functional collective, in launch order, as a
    :class:`CollectiveCall`: its kind (``launch/op_cost.py``'s tables, and
    ``send``/``recv``/``barrier``), the global ranks of its group, its
    operands' shapes and dtypes, the reduce op or the point-to-point peer,
    the port's ``file:line`` that issued it and the launch label it ran
    under;
  * every op that makes the host wait for the device (``HOST_SYNC_OPS``
    and copies from a device to the CPU), as a :class:`HostSync`. On CUDA
    the log also runs the step under ``torch.cuda.set_sync_debug_mode(
    "warn")``: a sync inside a backend op (a copy from host memory, a
    count read back to size an output) never reaches a dispatch mode, but
    its warning is caught. C++ warnings surface when the outermost call
    from Python returns, so the record names the port line that made that
    call, and the op where it is the dispatched op itself; a sync in a
    backward op is named ``<a backward op>`` at the line that ran the
    backward.

DTensor ops are let through, so the local collectives DTensor issues are
recorded; the ops of its sharding propagation are skipped, as
``launch/op_cost.OpCounter`` skips them.

**Launch labels.** The reference keys its per-branch budgets on the
``lax.switch`` branches of the overlapped executor. The port's executor
has no switch: it calls ``run_chunks(t, s, ids)`` at a drain tick, or
after the loop (tick -1), inside :func:`launch_label`, and the log files
the collectives launched there under ``(t, s)``. The label changes nothing
the executor does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
import warnings
from typing import Any, Iterable

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.op_cost import (C10D_COLLECTIVES,
                                        FUNCTIONAL_COLLECTIVES,
                                        FUNCTIONAL_NAMESPACES, _tensors,
                                        is_program_op, process_group)

__all__ = ["COLLECTIVE_OPS", "HOST_SYNC_OPS", "P2P_KINDS", "CollectiveCall",
           "CollectiveLog", "HostSync", "RankLog", "collective_signature",
           "count_collectives", "launch_label"]

# (namespace, op) -> kind: op_cost's collectives, with the point-to-point
# ops split into send and recv (a pair is matched across two ranks) and
# the barrier, which moves no data but every member must enter
COLLECTIVE_OPS = {
    **{("c10d", name): kind for name, (kind, _) in C10D_COLLECTIVES.items()},
    **{(ns, name): kind for ns in FUNCTIONAL_NAMESPACES
       for name, kind in FUNCTIONAL_COLLECTIVES.items()},
    ("c10d", "send"): "send",
    ("c10d", "recv_"): "recv",
    ("c10d", "recv_any_source_"): "recv",
    ("c10d", "barrier"): "barrier",
}
P2P_KINDS = frozenset({"send", "recv"})

# aten ops whose result the host must read back from the device; a copy to
# the CPU of a tensor on another device is one too (``copy_`` and
# ``_to_copy``, which ``.cpu()``, ``.tolist()`` and ``.numpy()`` reach)
HOST_SYNC_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "unique",
    "_unique", "_unique2", "unique_dim", "unique_consecutive",
    "unique_dim_consecutive", "equal", "is_nonzero",
})
_COPIES = frozenset({"_to_copy", "copy_"})

_PORT = os.sep + "repro_torch" + os.sep
_SELF = os.path.dirname(os.path.abspath(__file__)) + os.sep
_SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One collective launch: everything that must match across the ranks
    of its group."""

    kind: str
    group: tuple[int, ...]                               # global ranks
    operands: tuple[tuple[tuple[int, ...], str], ...]   # ((shape, dtype), ...)
    params: tuple[tuple[str, str], ...] = ()            # reduce op / peer
    path: str = ""                # the port's file:line (diagnostics only)
    label: tuple[int, int] | None = None                # (tick, stage)

    def matches(self, other: "CollectiveCall") -> bool:
        """Signature equality: everything except where it was issued."""
        return (self.kind == other.kind and self.group == other.group
                and self.operands == other.operands
                and self.params == other.params)

    def peer(self) -> int | None:
        return next((int(v) for k, v in self.params if k == "peer"), None)

    def describe(self) -> str:
        ops = ", ".join(f"{dt}{list(shp)}" for shp, dt in self.operands)
        extra = "".join(f" {k}={v}" for k, v in self.params)
        return f"{self.kind}[{','.join(map(str, self.group))}]({ops}){extra}"


@dataclasses.dataclass(frozen=True)
class HostSync:
    """One op that made (or would make) the host wait for the device."""

    op: str                       # aten op name
    path: str                     # the port's file:line
    label: tuple[int, int] | None = None
    how: str = "dispatch"         # "dispatch" | "sync-debug"


@dataclasses.dataclass
class RankLog:
    """What one rank recorded (picklable: the audit's workers return it)."""

    rank: int = 0
    calls: list[CollectiveCall] = dataclasses.field(default_factory=list)
    host_syncs: list[HostSync] = dataclasses.field(default_factory=list)
    labels: list[tuple[int, int]] = dataclasses.field(default_factory=list)


# ------------------------------------------------------------ launch labels
_LABELS: list[tuple[int, int]] = []
_ACTIVE: list["CollectiveLog"] = []


@contextlib.contextmanager
def launch_label(tick: int, stage: int):
    """Files the collectives launched inside under ``(tick, stage)`` in
    every active log (the executor's ``run_chunks``)."""
    label = (int(tick), int(stage))
    for log in _ACTIVE:
        log.labels.append(label)
    _LABELS.append(label)
    try:
        yield
    finally:
        _LABELS.pop()


def _current_label() -> tuple[int, int] | None:
    return _LABELS[-1] if _LABELS else None


# ------------------------------------------------------------------- sites
def _relative(filename: str) -> str:
    i = filename.rfind(_PORT)
    return filename[i + 1:] if i >= 0 else filename


def _is_port(filename: str) -> bool:
    return _PORT in filename and not filename.startswith(_SELF)


def _port_site(frame=None) -> str | None:
    """``repro_torch/<file>:<line>`` of the innermost frame of the port
    (the analysis package left out) on the stack from ``frame`` out."""
    f = frame if frame is not None else sys._getframe(1)
    while f is not None:
        if _is_port(f.f_code.co_filename):
            return f"{_relative(f.f_code.co_filename)}:{f.f_lineno}"
        f = f.f_back
    return None


def _in_backward() -> bool:
    """Whether the autograd engine is running on this stack: a warning it
    buffered in a backward op surfaces when the backward returns."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "_engine_run_backward":
            return True
        f = f.f_back
    return False


def _backward_site() -> str | None:
    """In a backward op (on the autograd engine's thread, where no frame
    of the port is on the stack): the node that runs it."""
    node = torch._C._current_autograd_node()
    return None if node is None else f"<backward of {node.name()}>"


# --------------------------------------------------------------- the mode
def _reduce_op(args) -> str | None:
    for a in args:
        if isinstance(a, str) and a in ("sum", "avg", "max", "min",
                                        "product", "premul_sum"):
            return a
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith("ReduceOp"):
            return dist.ReduceOp.RedOpType(a.op()).name.lower()
    return None


def _operands(args) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                 for t in _tensors(args[0] if args else ()))


def _is_sync_op(name: str, args, out) -> bool:
    """A ``HOST_SYNC_OPS`` op, or a copy from a device to the CPU."""
    if name in HOST_SYNC_OPS:
        return True
    if not any(t.device.type != "cpu" for t in _tensors(args)):
        return False
    dst = args[0] if name == "copy_" else out
    return any(t.device.type == "cpu" for t in _tensors(dst))


class CollectiveLog(TorchDispatchMode):
    """Records one rank's collectives and host syncs while it is entered
    (see the module docstring); its data is a :class:`RankLog`
    (``calls``, ``host_syncs``, ``labels``, ``freeze()``).

    ``sync_debug`` (default: whether CUDA is initialised) runs the region
    under ``torch.cuda.set_sync_debug_mode("warn")`` and files each sync
    warning as a host sync; the old mode is restored on exit.
    """

    def __init__(self, rank: int | None = None, *,
                 sync_debug: bool | None = None) -> None:
        super().__init__()
        self.rank = rank
        self.sync_debug = sync_debug
        self.calls: list[CollectiveCall] = []
        self.host_syncs: list[HostSync] = []
        self.labels: list[tuple[int, int]] = []
        self._fake = None
        self._ops = threading.local()
        self._stack = contextlib.ExitStack()

    # ------------------------------------------------------------ region
    def __enter__(self):
        if self.rank is None:
            self.rank = dist.get_rank() if dist.is_initialized() else 0
        if self.sync_debug is None:
            self.sync_debug = torch.cuda.is_available() and \
                torch.cuda.is_initialized()
        self._fake = active_fake_mode()
        st = self._stack
        if self.sync_debug:
            old = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            st.callback(torch.cuda.set_sync_debug_mode, old)
            st.enter_context(warnings.catch_warnings())
            warnings.filterwarnings("always", message=".*" + _SYNC_WARNING)
            shown = warnings.showwarning

            def show(message, category, filename, lineno, file=None,
                     line=None):
                if _SYNC_WARNING in str(message):
                    self._on_sync_warning()
                else:
                    shown(message, category, filename, lineno, file, line)

            warnings.showwarning = show
        _ACTIVE.append(self)
        st.callback(_ACTIVE.remove, self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def freeze(self) -> RankLog:
        return RankLog(rank=int(self.rank or 0), calls=list(self.calls),
                       host_syncs=list(self.host_syncs),
                       labels=list(self.labels))

    # ------------------------------------------------------------ records
    @staticmethod
    def _site() -> str:
        return _port_site(sys._getframe()) or _backward_site() \
            or "<outside the port>"

    def _on_sync_warning(self) -> None:
        running = getattr(self._ops, "running", None)
        op = "<a backward op>" if _in_backward() else "<no dispatched op>"
        if running is not None:
            func, args, kwargs = running
            if not is_program_op(self._fake, _tensors((args, kwargs))):
                return            # DTensor's propagation, not the step
            op = f"aten.{func._overloadpacket.__name__}"
        self.host_syncs.append(HostSync(op=op, path=self._site(),
                                        label=_current_label(),
                                        how="sync-debug"))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ns, name = func.namespace, func._overloadpacket.__name__
        kind = COLLECTIVE_OPS.get((ns, name))
        sync_op = name in HOST_SYNC_OPS or name in _COPIES
        if kind is None and not sync_op:
            if not self.sync_debug:
                return func(*args, **kwargs)
            # the sync debug mode's warning names the op that was running
            # (its owner is checked only when one arrives)
            ops = self._ops
            prev = getattr(ops, "running", None)
            ops.running = (func, args, kwargs)
            try:
                return func(*args, **kwargs)
            finally:
                ops.running = prev
        ours = is_program_op(self._fake, _tensors((args, kwargs)))
        site = None
        if ours and kind is not None:
            site = self._site()
            self._collective(func, kind, args, site)
        if ours and name == "_local_scalar_dense" and self._fake is not None \
                and type(args[0]) is FakeTensor:
            # a fake tensor has no value: the read is recorded, and the
            # program goes on with a zero of the right type
            self._host_sync(f"aten.{name}", site or self._site())
            dt = args[0].dtype
            return (False if dt == torch.bool else
                    0.0 if dt.is_floating_point else 0)
        ops = self._ops
        prev = getattr(ops, "running", None)
        ops.running = (func, args, kwargs) if ours and self.sync_debug \
            else None
        try:
            out = func(*args, **kwargs)
        finally:
            ops.running = prev
        if ours and sync_op and _is_sync_op(name, args, out):
            self._host_sync(f"aten.{name}", site or self._site())
        return out

    def _host_sync(self, op: str, site: str) -> None:
        self.host_syncs.append(HostSync(op=op, path=site,
                                        label=_current_label()))

    def _collective(self, func, kind: str, args, site: str) -> None:
        pg = process_group(func, args)
        group = tuple(dist.get_process_group_ranks(pg)) if pg is not None \
            else ()
        params = []
        red = _reduce_op(args)
        if red is not None:
            params.append(("op", red))
        if kind in P2P_KINDS and pg is not None:
            params.append(("peer", str(dist.get_global_rank(pg, args[2]))))
        self.calls.append(CollectiveCall(
            kind=kind, group=group, operands=_operands(args),
            params=tuple(params), path=site, label=_current_label()))


# ----------------------------------------------------------------- queries
def _calls(log: Any) -> list[CollectiveCall]:
    return list(log.calls) if hasattr(log, "calls") else list(log)


def collective_signature(log: Any, group: Iterable[int] | None = None,
                         ) -> tuple[CollectiveCall, ...]:
    """The ordered collectives of a log (or a sequence of calls), those on
    ``group`` (global ranks) only when it is given. Two ranks with equal
    signatures on a group launch the same collectives on it in the same
    order: the deadlock-freedom currency."""
    calls = _calls(log)
    if group is None:
        return tuple(calls)
    group = tuple(sorted(group))
    return tuple(c for c in calls if tuple(sorted(c.group)) == group)


def count_collectives(log: Any, kind: str | None = None) -> int:
    """Number of collectives a log recorded (of ``kind`` only, e.g.
    ``"all-reduce"``, when given)."""
    return sum(1 for c in _calls(log) if kind is None or c.kind == kind)
