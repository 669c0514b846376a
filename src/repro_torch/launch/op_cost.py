"""Per-rank cost counter of an eager torch program.

The port's counterpart of ``repro/launch/hlo_cost.py``. The reference
parses the partitioned HLO text of a compiled step and walks its
computations; here :class:`OpCounter`, a ``TorchDispatchMode``, sees every
aten op one rank dispatches while the program runs (on fake tensors in the
dry run, ``launch/dryrun.py``) and returns ``analyze_hlo``'s keys
(``hlo_cost.py:215-279``):

  * ``flops``: matmul-family work only (mm, bmm, addmm, baddbmm, which is
    what ``matmul``, ``einsum`` and ``linear`` dispatch to, convolution and
    scaled-dot-product attention), by ``torch.utils.flop_counter``'s
    formulas; elementwise work is left out, as the reference's
    ``_dot_flops`` counts dots only. The model's Python layer loops run
    unrolled, so every layer's ops are seen once each: no trip-count
    scaling (the reference's ``_trip_count``) is needed.
  * ``bytes``: unfused eager HBM traffic, the input plus output bytes of
    every aten op that materialises a result. View ops (``view``,
    ``transpose``, ``expand``, ``select``, ``as_strided``, ..., every op
    whose schema aliases its output) and allocations without a write
    (``empty``) cost nothing, the counterpart of ``_FREE``. This is the
    traffic of the eager program, not of XLA's fusion boundaries, so it is
    larger than the reference's count for the same step.
  * ``collective_bytes``: result bytes by the reference's kinds
    (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), over the c10d ops (``allreduce_``,
    ``allgather_``, ``_allgather_base_``, ``reduce_scatter_``,
    ``alltoall_``, and ``send``/``recv_`` as the counterpart of a
    collective permute, whose result is the received buffer) and the
    functional collectives DTensor issues (``_c10d_functional.*``); a
    broadcast, which the reference's programs do not issue, under its own
    kind.
  * ``collective_bytes_cross`` / ``collective_bytes_intra``: with
    ``pod_size`` > 0 a collective whose group's global ranks span a
    ``rank // pod_size`` boundary is cross-pod (``crosses_pod``,
    ``hlo_cost.py:188-212``); the ranks come from the group object of a
    c10d op or the group name of a functional one.

DTensor ops are let through to DTensor (the mode returns
``NotImplemented``), so the counter sees the local ops on this rank's
shards. Not the program's, and not counted: the ops DTensor's sharding
propagation runs on global shapes to learn an output's metadata (under
the caller's fake mode when there is one, else under one of its own) or
traces through an op's decomposition on meta tensors, known by the
propagation's frames and by the meta device, and under a fake mode any
op on real tensors (the device mesh's bookkeeping).

The counter also keeps a live-storage tally: every storage an op creates
is counted from its creation until it is freed, on top of the storages
``track`` registers (the step's arguments); ``peak_bytes`` is the largest
live total seen.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from typing import Any

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCounter", "storage_bytes"]

_fc = torch.ops._c10d_functional

# c10d op -> (kind, index of the argument whose tensors are the result)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_coalesced_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "recv_": ("collective-permute", 0),
    "broadcast_": ("broadcast", 0),
}
# functional collective -> kind (the result is the op's output)
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_FUNCTIONAL_NS = ("_c10d_functional", "_c10d_functional_autograd")

# allocations that write nothing, and the wait that only hands back its input
_FREE = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
         torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
         torch.ops.aten.new_empty_strided.default,
         torch.ops.aten.lift_fresh.default, _fc.wait_tensor.default}


def _tensors(x) -> list[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an op's arguments)."""
    out, stack = [], [x]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    return out


_KINDS: dict = {}
_WAIT = _fc.wait_tensor.default


def _op_kind(func) -> tuple:
    """(free, FLOP formula or None, (collective kind, result argument index
    or None for the output) or None, nothing to count) of an op, computed
    once: an op is free if it writes nothing (a view, an allocation) or
    returns no tensor (``prim.device``, a scalar read)."""
    kind = _KINDS.get(func)
    if kind is None:
        ns, name = func.namespace, func._overloadpacket.__name__
        coll = None
        if ns == "c10d" and name in _C10D:
            coll = _C10D[name]
        elif ns in _FUNCTIONAL_NS and name in _FUNCTIONAL:
            coll = (_FUNCTIONAL[name], None)
        flop = flop_registry.get(func._overloadpacket)
        free = (func in _FREE or func.is_view
                or not any("Tensor" in str(r.type) for r in func._schema.returns))
        kind = _KINDS[func] = (free, flop, coll,
                               free and flop is None and coll is None)
    return kind


def _flops(flop, args, kwargs, out) -> int:
    """``flop_registry``'s formula on an op's arguments; an ``out_dtype``
    (``bmm.dtype``) is not one of its shapes."""
    args = tuple(a for a in args if not isinstance(a, torch.dtype))
    kwargs = {k: v for k, v in kwargs.items() if k != "out_dtype"}
    return flop(*args, **kwargs, out_val=out)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storages(t: torch.Tensor) -> list:
    if isinstance(t, DTensor):
        t = t._local_tensor
    return [t.untyped_storage()]


def storage_bytes(x: Any) -> int:
    """Bytes of the distinct storages under the tensors of ``x`` (a DTensor
    counts its local shard)."""
    seen, total = set(), 0
    for t in _tensors(x):
        for st in _storages(t):
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


def _group_ranks(func, args) -> list[int] | None:
    """Global ranks of the group a collective runs on."""
    ns = func.namespace
    if ns == "c10d":
        pg = None
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = dist.ProcessGroup.unbox(a)
                    break
                except RuntimeError:
                    continue
        if pg is None:
            return None
        if func.__name__.startswith(("send", "recv_")):
            peer = dist.get_global_rank(pg, args[2])
            return [dist.get_rank(), peer]
        return dist.get_process_group_ranks(pg)
    name = next((a for a in args if isinstance(a, str)
                 and a not in ("sum", "avg", "max", "min", "product")), None)
    if name is None:
        return None
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(name))


# DTensor's sharding propagation: the ops it runs on global shapes to learn
# an output's metadata, and those of an op's decomposition it traces for a
# strategy (on meta tensors)
_PROPAGATION = frozenset({"_propagate_tensor_meta_non_cached",
                          "_propagate_through_decomp"})


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is running the op, inside
    the caller's own fake mode."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in _PROPAGATION:
            return True
        f = f.f_back
    return False


class OpCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes and collective bytes (see the module
    docstring); ``result()`` returns them under ``analyze_hlo``'s keys.

    ``pod_size`` > 0 splits the collective bytes into intra- and
    cross-pod. ``track(tree)`` registers tensors that live through the
    counted region (the arguments) in the live-storage tally.
    """

    def __init__(self, pod_size: int = 0) -> None:
        super().__init__()
        self.pod_size = pod_size
        self.flops = 0
        self.bytes = 0
        self.coll = defaultdict(int)
        self.coll_cross = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, tuple[weakref.ref, int]] = {}
        self._fake = None

    # --------------------------------------------------------- live storage
    def _free(self, key: int) -> None:
        ref_n = self._live.pop(key, None)
        if ref_n is not None:
            self.live_bytes -= ref_n[1]

    def _add_storage(self, st) -> None:
        key = id(st)
        if key in self._live and self._live[key][0]() is st:
            return
        n = st.nbytes()
        self._live[key] = (weakref.ref(st, lambda _, k=key: self._free(k)), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def track(self, x: Any) -> int:
        """Registers the storages of ``x``'s tensors as live; returns their
        bytes (counted once each)."""
        before = self.live_bytes
        for t in _tensors(x):
            for st in _storages(t):
                self._add_storage(st)
        return self.live_bytes - before

    def reset_peak(self) -> None:
        self.peak_bytes = self.live_bytes

    # -------------------------------------------------------------- dispatch
    def __enter__(self):
        self._fake = active_fake_mode()
        return super().__enter__()

    def _counted(self, tensors: list[torch.Tensor]) -> bool:
        fake = self._fake
        if fake is None:          # real tensors: propagation runs on fakes
            return not any(type(t) is FakeTensor for t in tensors)
        if not any(type(t) is FakeTensor and t.fake_mode is fake
                   for t in tensors):
            return False
        # no program runs on the meta device: only a propagation does
        if any(t.device.type == "meta" for t in tensors):
            return False
        return not _in_sharding_propagation()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is _WAIT and self._fake is not None:
            # the fake wait makes a new tensor; an eager wait returns its input
            out = args[0]
        else:
            out = func(*args, **kwargs)
        free, flop, coll, nothing = _op_kind(func)
        if nothing:
            return out            # a view or a metadata read
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not self._counted(ins + outs):
            return out
        if flop is not None:
            self.flops += _flops(flop, args, kwargs, out)
        if coll is not None:
            self._collective(func, coll, args, out)
        if free or not outs:
            return out
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            for st in _storages(t):
                self._add_storage(st)
        return out

    def _collective(self, func, coll, args, out) -> None:
        kind, i = coll
        b = sum(map(_nbytes, _tensors(out if i is None else args[i])))
        self.coll[kind] += b
        if self.pod_size:
            ranks = _group_ranks(func, args)
            pods = {r // self.pod_size for r in ranks or ()}
            if len(pods) > 1:
                self.coll_cross[kind] += b

    def result(self) -> dict:
        """``{flops, bytes, collective_bytes, collective_bytes_cross,
        collective_bytes_intra}``, as ``analyze_hlo`` returns them."""
        cross = dict(self.coll_cross)
        intra = {k: v - cross.get(k, 0) for k, v in self.coll.items()}
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collective_bytes": dict(self.coll),
                "collective_bytes_cross": cross,
                "collective_bytes_intra": intra}
