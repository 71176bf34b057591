"""The op census of a step: the port's counterpart of the reference's
``repro/core/hlo_analysis.py``.

The reference dissects a compiled HLO module (its "disassembly"): op
census, FLOPs of every dot, bytes of every fused op, payload of every
collective. The port has no HLO: its program is the sequence of aten and
c10d ops one step dispatches, so this module reads that. An ``OpTrace``
(a ``TorchDispatchMode``) records each op a function dispatches:

* its name (``aten.mm``, ``c10d.allreduce_``, or a hand-written
  kernel's, ``flash_decode``);
* its operands' and results' shapes and dtypes;
* its FLOPs, from ``torch.utils.flop_counter``'s registry (an op the
  registry lacks is decomposed first where it can be, as
  ``FlopCounterMode`` does, so the two count alike);
* its bytes: operands plus results, none for views, ``empty*`` or
  metadata ops (the reference's ``_FREE_OPS``); a gather or a scatter
  through an index is charged the rows it touches, not the whole tensor
  it indexes, as the reference charges a dynamic slice;
* for a ``c10d`` op, the collective's kind (the reference's names:
  ``"all-reduce"``, ...), its payload (the bytes of its result tensors,
  as the reference counts a collective's result) and its group's size.

A kernel wrapper called on meta tensors (``kernels.ops``: the dry run)
runs nothing and records one op under the kernel's name with its own
FLOPs and bytes (``record_kernel``), the analogue of a fusion, which
counts only its outside operands and results; on the card it records the
same op beside its launch, which no aten op shows.

``OpTrace.run(fn, *args)`` also notes the storages of the arguments and
of what ``fn`` returns, and follows the live bytes of every storage the
trace makes, through weakref finalizers on the tensors that hold it (it
works on meta tensors, which allocate nothing): the peak over the step is
the ``temp`` of ``memory_analysis_bytes``.

The reference's API is kept where its meaning carries over:
``CollectiveStats``, ``collective_stats``, ``op_census``,
``fusion_count`` (here the kernel calls: ops that are not free and not
collectives), ``dot_flops_census``; ``trace_flops``, ``trace_bytes`` and
``trace_collective_bytes`` replace the ``parsed_*`` functions (a trace
holds every layer's ops, so there are no loop trips to scale).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# c10d op -> the reference's collective kind.
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "collective-permute",
    "recv_": "collective-permute",
}

_aten = torch.ops.aten
# Ops that move no data: storage without values, and metadata.
_FREE = {_aten.empty.memory_format, _aten.empty_like.default,
         _aten.empty_strided.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten.lift_fresh.default,
         _aten.detach.default, _aten.alias.default}
# Queries answered without a kernel (``FlopCounterMode`` passes these by).
_METADATA = {_aten.sym_is_contiguous.default, _aten.is_contiguous.default,
             _aten.is_contiguous.memory_format,
             _aten.is_strides_like_format.default,
             _aten.is_non_overlapping_and_dense.default,
             _aten.size.default, _aten.sym_size.default,
             _aten.stride.default, _aten.sym_stride.default,
             _aten.storage_offset.default,
             _aten.sym_storage_offset.default, _aten.numel.default,
             _aten.sym_numel.default, _aten.dim.default,
             torch.ops.prim.layout.default}
_DOTS = {"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
         "aten.convolution", "aten._scaled_mm"}
# Reads through an index: the rows touched, not the indexed tensor (the
# reference charges a dynamic slice at its slice's size).
_GATHERS = {"aten.index", "aten.gather", "aten.index_select",
            "aten.embedding", "aten.take", "aten.take_along_dim"}
# Writes through an index into their first operand, in place or into a
# copy: the values written, read and written, not the whole destination.
_SCATTERS = {"aten.index_put_", "aten.index_put", "aten._index_put_impl_",
             "aten.scatter", "aten.scatter_", "aten.scatter_add",
             "aten.scatter_add_", "aten.index_copy", "aten.index_copy_",
             "aten.index_add", "aten.index_add_"}

Shape = Tuple[Tuple[int, ...], str]


@dataclasses.dataclass
class Op:
    name: str
    operands: Tuple[Shape, ...]
    results: Tuple[Shape, ...]
    flops: int = 0
    nbytes: int = 0
    free: bool = False
    kernel: bool = False            # a hand-written kernel's meta call
    kind: Optional[str] = None      # collective kind
    payload: int = 0                # collective result bytes
    group: int = 0                  # collective group size


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shapes(ts) -> Tuple[Shape, ...]:
    return tuple((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                 for t in ts)


def _storage(t: torch.Tensor) -> Tuple[int, int]:
    """(a key of ``t``'s storage, its bytes)."""
    s = t.untyped_storage()
    return s._cdata, s.nbytes()


_RECORDING = threading.local()


def _active() -> List["OpTrace"]:
    if not hasattr(_RECORDING, "traces"):
        _RECORDING.traces = []
    return _RECORDING.traces


def recording() -> bool:
    """Whether an ``OpTrace`` records on this thread."""
    return bool(_active())


def record_kernel(name: str, inputs, outputs, flops: int,
                  nbytes: int) -> None:
    """One op under a hand-written kernel's ``name`` in every recording
    trace: a kernel wrapper's meta call, with the kernel's FLOPs and
    bytes (``kernels.cost``)."""
    for trace in _active():
        trace.ops.append(Op(name, _shapes(_tensors(inputs)),
                            _shapes(_tensors(outputs)), flops=int(flops),
                            nbytes=int(nbytes), kernel=True))


class OpTrace(TorchDispatchMode):
    """Records every op dispatched while it is active (``with trace:``,
    or ``trace.run(fn, *args)``, which also notes arguments and
    outputs). ``ops`` holds the ``Op``s in order; ``peak_bytes`` the most
    bytes the storages made under the trace held at once."""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []
        self._live: Dict[int, List[int]] = {}   # key -> [bytes, holders]
        self.live_bytes = 0
        self.peak_bytes = 0
        self._args: Dict[int, int] = {}
        self._outs: Dict[int, int] = {}

    def __enter__(self):
        _active().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active().remove(self)
        return super().__exit__(*exc)

    def run(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` traced; its argument and output
        storages noted for ``memory_analysis_bytes``."""
        for t in _tensors(list(args) + list(kwargs.values())):
            key, n = _storage(t)
            self._args[key] = n
        with self:
            out = fn(*args, **kwargs)
        for t in _tensors(out):
            key, n = _storage(t)
            self._outs[key] = n
        return out

    # Live bytes: a storage made under the trace counts from its first
    # holder's creation to its last holder's death.
    def _hold(self, t: torch.Tensor, new: bool) -> None:
        key, n = _storage(t)
        if key in self._args:
            return
        entry = self._live.get(key)
        if entry is None:
            if not new:
                return                  # a view of a tensor made outside
            entry = self._live[key] = [n, 0]
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        packet = func._overloadpacket
        c10d = func.namespace == "c10d"
        if not c10d and packet not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors(out)
        view = bool(getattr(func, "is_view", False))
        free = view or func in _FREE
        op = Op(str(packet), _shapes(ins), _shapes(outs), free=free)
        if packet in flop_registry:
            op.flops = int(flop_registry[packet](*args, **kwargs,
                                                 out_val=out))
        if not free:
            op.nbytes = _op_bytes(op.name, ins, outs)
        if c10d:
            op.kind = _C10D_KINDS.get(packet.__name__, packet.__name__)
            op.payload = sum(map(_nbytes, _tensors(args[0])))
            group = next((a for a in args
                          if isinstance(a, torch.ScriptObject)
                          and "ProcessGroup" in str(a._type())), None)
            op.group = (dist.ProcessGroup.unbox(group).size()
                        if group is not None else 1)
        self.ops.append(op)
        for t in outs:
            self._hold(t, new=not view and not any(t is i for i in ins))
        return out


def _op_bytes(name: str, ins, outs) -> int:
    """Operand and result bytes of one op, slice-aware: a gather reads
    and writes its result's bytes (and its indices), a scatter its
    values' (and its indices), whatever the size of the tensor it
    indexes; any other op reads its operands and writes its results."""
    if name in _GATHERS:
        return sum(map(_nbytes, ins[1:])) + 2 * sum(map(_nbytes, outs))
    if name in _SCATTERS:
        return 2 * sum(map(_nbytes, ins[1:]))
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


# ----------------------------------------------------------------------------
# The reference's readings, from a trace
# ----------------------------------------------------------------------------

def collective_stats(trace: OpTrace) -> CollectiveStats:
    """Payload bytes and count of each collective kind."""
    bytes_by: Counter = Counter()
    count_by: Counter = Counter()
    for op in trace.ops:
        if op.kind is not None:
            bytes_by[op.kind] += op.payload
            count_by[op.kind] += 1
    return CollectiveStats(dict(bytes_by), dict(count_by))


def op_census(trace: OpTrace, include_free: bool = True) -> Dict[str, int]:
    """Op name -> how many times the step dispatched it; without
    ``include_free``, only the ops that move data (the free ones, views,
    ``empty*`` and the like, differ where a kernel allocates its own
    scratch on the card and not on meta)."""
    return dict(Counter(op.name for op in trace.ops
                        if include_free or not op.free))


def fusion_count(trace: OpTrace) -> int:
    """Kernel calls: the ops that are neither free nor collectives (each
    launches one kernel on the card; a hand-written kernel's meta call
    counts as one)."""
    return sum(1 for op in trace.ops if not op.free and op.kind is None)


def dot_flops_census(trace: OpTrace) -> int:
    """Matrix products and convolutions (the tensor cores' ops)."""
    return sum(1 for op in trace.ops if op.name in _DOTS)


def trace_flops(trace: OpTrace) -> float:
    return float(sum(op.flops for op in trace.ops))


def trace_bytes(trace: OpTrace) -> float:
    """Operand and result bytes of every op that is not free: the
    unfused traffic (each op reads its inputs and writes its outputs)."""
    return float(sum(op.nbytes for op in trace.ops))


# Elementwise ops whose every output element takes a transcendental.
_TRANSCENDENTAL = {"aten.exp", "aten.exp2", "aten.log", "aten.log1p",
                   "aten.tanh", "aten.sigmoid", "aten.silu", "aten.rsqrt",
                   "aten.sqrt", "aten.sin", "aten.cos", "aten.gelu",
                   "aten.softplus", "aten.erf", "aten.pow",
                   "aten._softmax", "aten.logsumexp"}


def trace_transcendentals(trace: OpTrace) -> float:
    """Output elements of the transcendental ops (XLA's
    ``transcendentals``)."""
    return float(sum(math.prod(shape) for op in trace.ops
                     if op.name in _TRANSCENDENTAL
                     for shape, _ in op.results[:1]))


def trace_collective_bytes(trace: OpTrace) -> float:
    return float(collective_stats(trace).total_bytes)


def memory_analysis_bytes(trace: OpTrace) -> Dict[str, float]:
    """The reference's five keys, from a ``run``: ``argument_bytes`` the
    storages of the rank's inputs, ``output_bytes`` of what the function
    returned, ``alias_bytes`` the outputs that are inputs updated in
    place (caches, parameters, state), ``temp_bytes`` the peak of the
    storages made during the step held at once, ``code_bytes`` 0."""
    alias = sum(n for k, n in trace._outs.items() if k in trace._args)
    return {"argument_bytes": float(sum(trace._args.values())),
            "output_bytes": float(sum(trace._outs.values())),
            "temp_bytes": float(trace.peak_bytes),
            "alias_bytes": float(alias),
            "code_bytes": 0.0}
