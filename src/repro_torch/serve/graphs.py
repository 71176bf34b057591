"""Repeating engine steps, run eagerly or replayed as captured CUDA graphs:
the port's counterpart of the reference's jitted step executables
(``repro/serve/engine.py`` ``_make_decode_step``, ``_make_chunk_fn``).

A step is a function of no arguments: it reads its inputs from static
device buffers, which the engine fills before each run, and writes its
output into a static buffer. ``Step(fn, device, capture)`` on a CUDA
device first runs ``fn`` once (the warm-up, which makes the stream's
cuBLAS workspace and the kernels' zeroed counters, loads the kernel
library and grows the allocator), on the stream its calls will use: a
stream of its own when it captures, the current one when it does not.
With ``capture=True`` it then captures ``fn`` on that stream into a CUDA
graph, and every call replays the graph. On the CPU, or with
``capture=False``, every call runs ``fn``. Nothing falls back: a capture
or a replay that fails raises.

``Step(..., tel=, name=)`` times each run as the device span ``name`` of
the engine's ``serve.telemetry.Telemetry`` when that times device spans.
Captured, the graph then holds a pair of timing events as its first and
last node, which each replay re-binds to a pair of the telemetry's pooled
events (``cuGraphExecEventRecordNodeSetEvent``), so the span starts when
the device starts the graph and a launch's host latency falls before it.
The capture checks, by one replay, that the bound events time, and raises
where they do not. Run eagerly, the pair is recorded around the run.
Untimed, the graph holds the step's own nodes alone.

``ops.LAUNCHES`` counts wrapper calls, which a replay does not make. The
capture counts the wrapper calls it records, then reads the captured
graph's kernel nodes back from the driver and raises unless each of the
port's kernels appears there as often as its wrapper was called. Each
replay adds the nodes read; the warm-up's and the capture's own launches
are taken back out. A run then counts the same launches graphed as eager.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import ops

# The port's kernels, by fragments of their mangled names, and the
# ``ops.LAUNCHES`` key of the wrapper that launches each. Every one sits
# in an anonymous namespace (``_GLOBAL__N_``), which no library kernel
# combines with these names, and the attention kernels are told apart by
# the layout they are instantiated for.
ANON = "_GLOBAL__N_"
KERNELS = ((("decode_split_kernel", "PagedLayout"), "flash_decode_paged"),
           (("decode_split_kernel", "ContiguousLayout"), "flash_decode"),
           (("prefill_kernel", "PagedLayout"), "flash_attention_paged"),
           (("prefill_mma_kernel", "PagedLayout"), "flash_attention_paged"),
           (("prefill_kernel", "ContiguousLayout"), "flash_attention"),
           (("prefill_mma_kernel", "ContiguousLayout"), "flash_attention"),
           (("ssd_scan_kernel",), "ssd_scan"),
           (("ssd_scan_mma_kernel",), "ssd_scan"),
           (("gemm_kernel",), "gemm"),
           (("gemm_wgmma_kernel",), "gemm"),
           (("pchase_kernel",), "pchase"),
           (("pchase_timed_kernel",), "pchase_timed"))

_KERNEL_NODE = 0          # CU_GRAPH_NODE_TYPE_KERNEL
_EVENT_RECORD_NODE = 7    # CU_GRAPH_NODE_TYPE_EVENT_RECORD
_P = ctypes.c_void_p


def _libcuda():
    """The CUDA driver library (``libcuda``), with the argument types of
    the calls made here declared."""
    cuda = ctypes.CDLL("libcuda.so.1")
    for name, args in (
            ("cuGraphGetNodes", (_P, _P, ctypes.POINTER(ctypes.c_size_t))),
            ("cuGraphNodeGetType", (_P, ctypes.POINTER(ctypes.c_int))),
            ("cuGraphEventRecordNodeGetEvent", (_P, ctypes.POINTER(_P))),
            ("cuGraphExecEventRecordNodeSetEvent", (_P, _P, _P))):
        fn = getattr(cuda, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return cuda


def _check(err: int, call: str) -> None:
    if err:
        raise RuntimeError(f"{call} failed: CUresult {err}")


def _nodes(cuda, raw_graph: int) -> list:
    graph = _P(raw_graph)
    n = ctypes.c_size_t(0)
    _check(cuda.cuGraphGetNodes(graph, None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (_P * n.value)()
    _check(cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    out = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int()
        _check(cuda.cuGraphNodeGetType(_P(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        out.append((_P(node), kind.value))
    return out


def event_nodes(raw_graph: int) -> Dict[int, object]:
    """A captured graph's event-record nodes, by the event each records
    (a ``cudaEvent_t`` as an int)."""
    cuda = _libcuda()
    out = {}
    for node, kind in _nodes(cuda, raw_graph):
        if kind == _EVENT_RECORD_NODE:
            ev = _P()
            _check(cuda.cuGraphEventRecordNodeGetEvent(node,
                                                       ctypes.byref(ev)),
                   "cuGraphEventRecordNodeGetEvent")
            out[ev.value] = node
    return out


def wrapper_of(name: str) -> Optional[str]:
    """The ``ops.LAUNCHES`` key of the port's kernel with mangled name
    ``name``; None for any other kernel."""
    if ANON not in name:
        return None
    return next((w for keys, w in KERNELS if all(k in name for k in keys)),
                None)


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2``."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def kernel_names(raw_graph: int) -> list:
    """The mangled names of a captured graph's kernel nodes (a
    ``cudaGraph_t`` as an int), read from the driver."""
    cuda = _libcuda()
    names = []
    for node, kind in _nodes(cuda, raw_graph):
        if kind != _KERNEL_NODE:
            continue
        p = _KernelNodeParams()
        _check(cuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
               "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func:
            _check(cuda.cuFuncGetName(ctypes.byref(name), _P(p.func)),
                   "cuFuncGetName")
        else:
            _check(cuda.cuKernelGetName(ctypes.byref(name), _P(p.kern)),
                   "cuKernelGetName")
        names.append(name.value.decode())
    return names


def count_wrappers(names) -> Dict[str, int]:
    """How many of ``names`` each of the port's wrappers launches."""
    counts: Dict[str, int] = {}
    for name in names:
        w = wrapper_of(name)
        if w is not None:
            counts[w] = counts.get(w, 0) + 1
    return counts


class Step:
    """``fn`` run eagerly, or captured once and replayed (see the module's
    docstring). ``launches`` are the wrapper calls the capture recorded,
    ``nodes`` the port's kernels read back from the captured graph (equal,
    or the capture raised); ``graph_bytes`` is the device memory of the
    graph's private pool: the segments the allocator holds for it.
    ``timing`` says how a run's device span ``name`` is timed: "graph"
    (events inside the graph), "eager" (around the run), or None (not
    timed)."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 capture: bool, tel=None, name: Optional[str] = None):
        self.fn = fn
        self.graph = None
        self.launches: Dict[str, int] = {}    # kernel -> wrapper calls
        self.nodes: Dict[str, int] = {}       # kernel -> graph nodes
        self.graph_bytes = 0
        timed = tel is not None and tel.timing
        self.tel = tel if timed else None
        self.name = name
        self.timing = "eager" if timed else None
        if device.type != "cuda":
            return
        counted = dict(ops.LAUNCHES)
        stream = torch.cuda.Stream(device) if capture \
            else torch.cuda.current_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self.fn()
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        if capture:
            self._capture(device, stream, timed)
        ops.LAUNCHES.update(counted)

    def _capture(self, device: torch.device, stream, timed: bool) -> None:
        before = dict(ops.LAUNCHES)
        # Kept, so that its nodes can be read after the capture.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        marks = [torch.cuda.Event(enable_timing=True, external=True)
                 for _ in range(2)] if timed else None
        with torch.cuda.graph(graph, stream=stream):
            if marks:
                marks[0].record(stream)
            self.fn()
            if marks:
                marks[1].record(stream)
        graph.instantiate()
        torch.cuda.synchronize(device)
        self.launches = {k: ops.LAUNCHES[k] - before[k] for k in before
                         if ops.LAUNCHES[k] != before[k]}
        self.nodes = count_wrappers(kernel_names(graph.raw_cuda_graph()))
        if self.nodes != self.launches:
            raise RuntimeError(f"the captured graph holds the kernels "
                               f"{self.nodes}, its wrappers were called "
                               f"{self.launches}")
        self.graph = graph
        pool = tuple(graph.pool())
        self.graph_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == pool)
        if timed:
            self._marks = marks
            self._bind_marks(device)
            self.timing = "graph"

    def _bind_marks(self, device: torch.device) -> None:
        """Find the graph's two event nodes and check, by one replay, that
        events bound to them time on this card; raise where they do not."""
        nodes = event_nodes(self.graph.raw_cuda_graph())
        self._event_nodes = [nodes[m.cuda_event] for m in self._marks]
        self._exec = _P(self.graph.raw_cuda_graph_exec())
        self._set_event = _libcuda().cuGraphExecEventRecordNodeSetEvent
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        b.record()
        self._bind(a, b)
        self.graph.replay()
        torch.cuda.synchronize(device)
        ms = a.elapsed_time(b)
        # The CUDA driver refuses to re-bind a node whose event was
        # destroyed: bind back the captured pair, which the step keeps.
        self._bind(*self._marks)
        if not ms > 0:
            raise RuntimeError(f"the events bound to the graph's first and "
                               f"last node read {ms} ms for a replay")

    def _bind(self, a, b) -> None:
        for node, ev in zip(self._event_nodes, (a, b)):
            _check(self._set_event(self._exec, node, _P(ev.cuda_event)),
                   "cuGraphExecEventRecordNodeSetEvent")

    def __call__(self, tick: int = 0, slot: Optional[int] = None) -> None:
        tel = self.tel
        if self.graph is None:
            if tel is None:
                self.fn()
                return
            with tel.device_span(self.name, tick, slot):
                self.fn()
            return
        if tel is not None:
            self._bind(*tel.device_marks(self.name, tick, slot))
        self.graph.replay()
        for name, n in self.nodes.items():
            ops.LAUNCHES[name] += n
