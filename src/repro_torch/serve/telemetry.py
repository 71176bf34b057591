"""Structured observability for the serving engine (port of
``repro/serve/telemetry.py``).

Three surfaces, one bookkeeping home:

* **Event trace** — a ring-buffered, schema-versioned stream of typed
  tick events (``admit``, ``shed``, ``preempt``, ``degrade_enter`` /
  ``degrade_exit``, ``spec_verify`` with accept counts,
  ``prefill_chunk``, ``page_alloc`` / ``page_free``, ``prefix_hit`` /
  ``prefix_miss`` / ``cow_copy`` / ``prefix_evict``, terminal outcomes)
  emitted from the engine's decision points. The engine's decision
  counters (``admission_rejections``, ``shed_by_class``,
  ``preemption_log``, the spec stats) are views over this trace's
  aggregates: the aggregate side of ``emit`` runs even when tracing is
  disabled (and after ring eviction), so the counters stay exact while
  the ring bounds memory.
* **Wall-clock spans** — ``perf_counter`` spans around the decode, verify
  and chunk steps, their loads, launches and reads, page work, token
  bookkeeping and the host's scheduling phases, each with the span open
  around it (``parent``), with a step's first run (its build: a capture
  or a first eager run) flagged ``compile``, plus a per-tick wall-time
  histogram (p50/p99). Spans measure host-observed time. While a
  ``torch.profiler`` records, each span also opens a
  ``record_function("engine.<name>")`` range, so a device trace holds the
  engine's spans beside its kernels.
* **Device spans** — on a CUDA engine with telemetry on, timing events
  (a reused pool) bracket every piece of device work the engine enqueues:
  loads, replays (recorded by the captured graph's first and last node,
  ``serve.graphs.Step``) and reads. They stay pending until ``settle()``,
  which the engine calls right after a read it already makes; the host
  clock then is the time of the last completed event. At the tick's end
  (or a reading) every settled event maps onto the host clock by its
  ``elapsed_time`` to that one, so the span around a read holds one clock
  read of telemetry's own. Each device span is counted as
  ``<name>.device``; each gap between two device spans is device idle,
  split over the host spans it overlaps and charged to the innermost as
  ``idle.<span>`` (``idle.tick`` inside a tick but in no span,
  ``idle.settle`` over the mapping itself, ``idle.outside`` between
  ticks).
  No synchronisation or host<->device transfer is added for telemetry,
  so a traced engine's streams equal an untraced engine's.
* **Exporters** — ``chrome_trace()`` emits a Chrome-trace/Perfetto JSON
  timeline (one track per engine phase with its child spans nested, one
  per slot, one for the device); ``metrics()`` flattens everything into
  one scalar dict.
* **Drift** — ``drift_report(engine)`` holds the serving cost models
  (``core.autotune``) against the engine's measured spans.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

TRACE_SCHEMA_VERSION = 1

# Typed event kinds (schema v1). ``emit`` asserts membership, so a typo'd
# kind fails loudly instead of minting an unqueryable stream.
EVENT_KINDS = frozenset({
    "submit",         # request entered the queue
    "admit",          # request installed into a slot
    "admit_hold",     # pool-exhausted admission hold (everyone waits)
    "shed",           # terminal: clean reject (queue_full/capacity/...)
    "finish",         # terminal: done | forced:* (partial stream kept)
    "preempt",        # slot evicted back to the queue
    "degrade_enter",  # ladder: clean -> degraded transition
    "degrade_exit",   # ladder: degraded -> clean transition
    "spec_verify",    # one slot's verify outcome (proposed/accepted)
    "prefill_chunk",  # one prompt chunk written through the page table
    "page_alloc",     # pages granted to a slot
    "page_free",      # a freed slot's pages returned to the pool
    "probe_tick",     # k=1 trial tick while speculation is disabled
    "prefix_hit",     # admission mapped cached prefix pages (refcounts)
    "prefix_miss",    # admission probed the prefix index and found none
    "cow_copy",       # copy-on-write split of a shared page
    "prefix_evict",   # LRU reclaim of cached-idle prefix pages
})

# Aggregate counters the port's engine keeps and the reference's does not:
# ``host_syncs``, its blocking host<->device transfers and reads.
PORT_COUNTERS = frozenset({"host_syncs"})


def _profiling() -> bool:
    """Whether a ``torch.profiler`` is recording (a cheap check)."""
    return torch._C._autograd._profiler_enabled()


class _Span:
    """Context manager recording one wall-clock span (and, with
    ``device``, the device span of the same name). ``compile`` is set by
    the caller, inside the block, from the engine's build counters."""

    __slots__ = ("_tel", "name", "tick", "slot", "rid", "compile", "parent",
                 "track", "seq", "_t0", "_rf", "_device", "_dev")

    def __init__(self, tel: "Telemetry", name: str, tick: int,
                 slot: Optional[int], rid: Optional[int], device: bool):
        self._tel = tel
        self.name = name
        self.tick = tick
        self.slot = slot
        self.rid = rid
        self.compile = False
        self._device = device

    def __enter__(self) -> "_Span":
        tel = self._tel
        parent = tel._open[-1] if tel._open else None
        self.parent = parent
        # A span nests in its parent's track; a slot's spans in the slot's.
        self.track = (f"slot:{self.slot}" if self.slot is not None
                      else parent.track if parent is not None
                      else f"phase:{self.name}")
        tel._seq += 1
        self.seq = tel._seq
        tel._open.append(self)
        self._rf = None
        if _profiling():
            self._rf = torch.autograd.profiler.record_function(
                "engine." + self.name)
            self._rf.__enter__()
        self._dev = tel._device_open(self.name, self.tick, self.slot) \
            if self._device else None
        self._t0 = tel._clock()
        return self

    def __exit__(self, *exc) -> None:
        tel = self._tel
        t1 = tel._clock()
        if self._dev is not None:
            tel._device_close(self._dev)
        tel._open.pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        tel._record_span(self, self._t0, t1)


class _DeviceSpan:
    """Context manager bracketing the device work enqueued in its block
    with a pair of pooled timing events (no host span)."""

    __slots__ = ("_tel", "_args", "_dev")

    def __init__(self, tel: "Telemetry", name: str, tick: int,
                 slot: Optional[int]):
        self._tel = tel
        self._args = (name, tick, slot)

    def __enter__(self) -> "_DeviceSpan":
        self._dev = self._tel._device_open(*self._args)
        return self

    def __exit__(self, *exc) -> None:
        self._tel._device_close(self._dev)


class _NullSpan:
    """Shared no-op span for disabled telemetry."""

    __slots__ = ("compile",)

    def __init__(self):
        self.compile = False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


def charge_idle(gaps: List[Tuple[float, float]],
                hosts: List[Tuple[float, float, str, int]]
                ) -> List[Tuple[str, float, float]]:
    """Split each idle gap ``(a, b)`` (in time order, disjoint) over the
    host intervals ``(t0, t1, name, seq)`` it overlaps, each part charged
    to the innermost interval covering it, or to ``outside`` where none
    does. The intervals nest (spans close in the order they opened; an
    open one has ``t1`` inf), so one sweep over their ends, with a stack
    of the intervals open, finds the innermost: the stack's top. Returns
    ``(name, start, end)`` parts in time order; each gap's parts tile it
    exactly."""
    out: List[Tuple[str, float, float]] = []
    if not gaps:
        return out
    lo = gaps[0][0]
    hosts = [h for h in hosts if h[1] > h[0]]     # an empty one covers none
    stack = sorted((h for h in hosts if h[0] <= lo < h[1]),
                   key=lambda h: h[3])
    # Ends after ``lo``: closes first at one time, inner ones first; then
    # opens, outer ones first.
    ends = sorted([(h[1], 0, -h[3], h) for h in hosts
                   if lo < h[1] < float("inf")]
                  + [(h[0], 1, h[3], h) for h in hosts if h[0] > lo],
                  key=lambda e: e[:3])
    i = 0

    def step(e) -> None:
        if e[1]:
            stack.append(e[3])
        elif stack and stack[-1] is e[3]:
            stack.pop()
        elif e[3] in stack:
            stack.remove(e[3])

    for a, b in gaps:
        while i < len(ends) and ends[i][0] <= a:
            step(ends[i])
            i += 1
        p = a
        while p < b:
            q = min(b, ends[i][0]) if i < len(ends) else b
            if q > p:
                name = stack[-1][2] if stack else "outside"
                if out and out[-1][0] == name and out[-1][2] == p:
                    out[-1] = (name, out[-1][1], q)
                else:
                    out.append((name, p, q))
            p = q
            while i < len(ends) and ends[i][0] <= p and p < b:
                step(ends[i])
                i += 1
    return out


class Telemetry:
    """One engine's observability state: event ring, aggregates, spans.

    Aggregates (``counters``, ``shed_by_class``, ``preemption_log``) are
    updated by every ``emit``/``count`` call whether or not ``enabled``;
    they back the engine's counter views and must stay exact. The ring
    buffers (events, spans, tick times), the clock reads and the device
    spans are what ``enabled`` gates.

    Device spans are timed when ``enabled`` and either ``device`` is a
    CUDA device (events: ``torch.cuda.Event(enable_timing=True)``) or
    ``new_event`` makes the events (anything with ``record()`` and
    ``elapsed_time(later)`` in ms); ``clock`` is the host clock
    (``time.perf_counter``, the clock a harness stamps tokens with)."""

    def __init__(self, enabled: bool = True, capacity: int = 4096,
                 device=None, clock: Callable[[], float] = time.perf_counter,
                 new_event: Optional[Callable[[], Any]] = None):
        assert capacity >= 1, capacity
        self.enabled = enabled
        self.capacity = capacity
        self.schema_version = TRACE_SCHEMA_VERSION
        self._clock = clock
        if new_event is None and device is not None \
                and torch.device(device).type == "cuda":
            new_event = lambda: torch.cuda.Event(  # noqa: E731
                enable_timing=True)
        self._new_event = new_event
        self.timing = enabled and new_event is not None
        # Ring entries: (t_rel_s, tick, kind, payload_dict).
        self.events: deque = deque(maxlen=capacity)
        # Ring entries: (name, t0_rel_s, dur_s, tick, slot, compile,
        # parent, rid, track).
        self.spans: deque = deque(maxlen=capacity)
        # Ring entries: (name, t0_rel_s, dur_s, tick, slot): the device
        # spans (``<name>.device``) and the idle parts (``idle.<span>``).
        self.device_spans: deque = deque(maxlen=capacity)
        # Ring entries: (tick, dur_s), the percentile window.
        self.tick_times: deque = deque(maxlen=capacity)
        self.dropped_events = 0          # ring evictions (aggregates exact)
        # Aggregates, exact over the whole run and never evicted.
        self.counters: Dict[str, Any] = {}
        self.shed_by_class: Dict[str, int] = {}
        self.preemption_log: List[Tuple[int, str, int]] = []
        # name -> [n, total_s, max_s, compile_n, compile_s]
        self._span_agg: Dict[str, List] = {}
        self._tick_n = 0
        self._tick_total_s = 0.0
        self._epoch = clock()
        # Open spans (innermost last) and their opening order.
        self._open: List[_Span] = []
        self._seq = 0
        # In flight between settles (kept across ``reset``): the events
        # recorded and not yet settled, in stream order; the device spans
        # [name, start, end, tick, slot] (events; the end is a host time
        # where a settle ended the span); the settled batches (anchor,
        # events, spans) not yet mapped; the events free for reuse; the
        # host intervals (t0, t1, name, seq) an idle gap may still
        # overlap; the open tick; the host time the device last went idle.
        self._evq: List[Any] = []
        self._dq: List[List] = []
        self._settled: List[Tuple[float, List[Any], List[List]]] = []
        self._pool: List[Any] = []
        self._hosts: List[Tuple[float, float, str, int]] = []
        self._tick_open: Optional[Tuple[float, int]] = None
        self._tick_end: Optional[float] = None
        self._dev_end: Optional[float] = None

    # -- recording ------------------------------------------------------------

    def count(self, key: str, n: int = 1) -> None:
        """Bump an aggregate counter with no ring event."""
        self.counters[key] = self.counters.get(key, 0) + n

    def emit(self, tick: int, kind: str, **payload) -> None:
        """Record one typed event. Aggregates always update; the ring
        entry is appended only when tracing is enabled."""
        assert kind in EVENT_KINDS, kind
        # Scalars of numpy (or torch) must not leak into the aggregates or
        # the ring: the exporters json-serialise them as they are.
        payload = {k: (v.item() if hasattr(v, "item") else v)
                   for k, v in payload.items()}
        c = self.counters
        c[kind] = c.get(kind, 0) + 1
        if kind == "shed":
            rc = payload["rclass"]
            self.shed_by_class[rc] = self.shed_by_class.get(rc, 0) + 1
        elif kind == "preempt":
            self.preemption_log.append(
                (payload["rid"], payload["rclass"], payload["n_generated"]))
        elif kind == "spec_verify":
            c["spec_proposed"] = c.get("spec_proposed", 0) \
                + payload["proposed"]
            c["spec_accepted"] = c.get("spec_accepted", 0) \
                + payload["accepted"]
            c["spec_emitted"] = c.get("spec_emitted", 0) \
                + payload["emitted"]
        if not self.enabled:
            return
        if len(self.events) == self.capacity:
            self.dropped_events += 1
        self.events.append((self._clock() - self._epoch, tick, kind, payload))

    def span(self, name: str, tick: int, slot: Optional[int] = None,
             rid: Optional[int] = None, device: bool = False):
        """Wall-clock span context manager; a no-op when disabled. With
        ``device`` it also times the device work enqueued in its block
        (``<name>.device``) when device spans are timed."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, tick, slot, rid, device and self.timing)

    def device_span(self, name: str, tick: int, slot: Optional[int] = None):
        """Times the device work enqueued in its block as ``<name>.device``
        (no host span); a no-op unless device spans are timed."""
        if not self.timing:
            return _NULL_SPAN
        return _DeviceSpan(self, name, tick, slot)

    def device_marks(self, name: str, tick: int, slot: Optional[int] = None):
        """Two pooled events queued as the device span ``name``, for a
        captured graph's first and last node to record: the caller binds
        them to the graph's event nodes and replays it."""
        a, b = self._take(), self._take()
        self._evq += (a, b)
        self._dq.append([name, a, b, tick, slot])
        return a, b

    def _take(self):
        if self._pool:
            return self._pool.pop()
        ev = self._new_event()
        ev.record()          # a CUDA event exists only once recorded
        return ev

    def _mark(self):
        ev = self._take()
        ev.record()
        self._evq.append(ev)
        return ev

    def _device_open(self, name: str, tick: int, slot: Optional[int]):
        d = [name, self._mark(), None, tick, slot]
        self._dq.append(d)
        return d

    def _device_close(self, d: List) -> None:
        if d[2] is None:     # a settle inside the block ended it already
            d[2] = self._mark()

    def settle(self) -> None:
        """Anchor the pending events to the host clock. Called right after
        a read that left the stream drained (so every pending event has
        completed): the host clock now is the time of the last event. A
        device span still open (the read's own) ends here. The events are
        mapped later (``_map``: at the tick's end or a reading), so that a
        span around the read holds no more than this clock read."""
        if not self._evq:
            return
        now = self._clock()
        for d in self._dq:
            if d[2] is None:
                d[2] = now           # ended: ``_device_close`` records none
        self._settled.append((now, self._evq, self._dq))
        self._evq, self._dq = [], []

    def _map(self) -> None:
        """Map the settled events onto the host clock: each event lies its
        ``elapsed_time`` before its batch's last, which is at the batch's
        anchor. Then each gap between consecutive device spans, from the
        last mapped one on, is charged to the host spans it overlaps
        (``charge_idle``). The mapping's own host time is the ``settle``
        span (a gap over it is charged to ``idle.settle``)."""
        if not self._settled:
            return
        t0 = self._clock()
        gaps = []
        end = self._dev_end
        for now, evq, dq in self._settled:
            last = evq[-1]
            at = {id(ev): now - ev.elapsed_time(last) / 1e3
                  for ev in evq[:-1]}
            at[id(last)] = now
            self._pool += evq
            for name, a, b, tick, slot in dq:
                a = at[id(a)]
                b = max(a, b if isinstance(b, float) else at[id(b)])
                if end is not None and a > end:
                    gaps.append((end, a))
                self._record_device(name + ".device", a, b - a, tick, slot)
                end = b if end is None else max(end, b)
        self._settled = []
        self._dev_end = end
        self._charge(gaps)
        self._seq += 1
        t1 = self._clock()
        self._hosts.append((t0, t1, "settle", self._seq))
        self._agg("settle", t1 - t0, False)

    def _charge(self, gaps: List[Tuple[float, float]]) -> None:
        """Charge idle ``gaps`` to the host spans, then drop the host
        intervals no later gap can overlap (those that ended before the
        device last went idle)."""
        hosts = self._hosts + [(sp._t0, float("inf"), sp.name, sp.seq)
                               for sp in self._open]
        if self._tick_open is not None:
            hosts.append((self._tick_open[0], float("inf"), "tick",
                          self._tick_open[1]))
        for name, a, b in charge_idle(gaps, hosts):
            self._record_device("idle." + name, a, b - a, None, None)
        if self._dev_end is not None:
            self._hosts = [h for h in self._hosts if h[1] > self._dev_end]

    def _flush_idle(self) -> None:
        """A reading with no device work in flight since the last settle:
        the device has been idle from its last span on. Inside a tick
        that much is charged up to now; between ticks, up to the end of
        the last tick, and the caller's time since (a profiler stopping,
        a harness between its window and its reading) is charged to no
        span. The next gap starts at the reading, so a reading splits the
        device's timeline at its own time."""
        if self._evq or self._settled or self._dev_end is None:
            return
        now = self._clock()
        end = now if self._tick_open is not None or self._tick_end is None \
            else min(now, self._tick_end)
        if end > self._dev_end:
            gap = [(self._dev_end, end)]
            self._dev_end = end
            self._charge(gap)
        self._dev_end = max(self._dev_end, now)

    def _agg(self, name: str, dur: float, compile_: bool) -> None:
        agg = self._span_agg.get(name)
        if agg is None:
            agg = self._span_agg[name] = [0, 0.0, 0.0, 0, 0.0]
        agg[0] += 1
        agg[1] += dur
        agg[2] = max(agg[2], dur)
        if compile_:
            agg[3] += 1
            agg[4] += dur

    def _record_device(self, name: str, t0: float, dur: float,
                       tick: Optional[int], slot: Optional[int]) -> None:
        self._agg(name, dur, False)
        self.device_spans.append((name, t0 - self._epoch, dur, tick, slot))

    def _record_span(self, sp: _Span, t0: float, t1: float) -> None:
        dur = t1 - t0
        self._agg(sp.name, dur, sp.compile)
        parent = sp.parent.name if sp.parent is not None else None
        self.spans.append((sp.name, t0 - self._epoch, dur, sp.tick,
                           sp.slot, sp.compile, parent, sp.rid, sp.track))
        if self.timing:
            self._hosts.append((t0, t1, sp.name, sp.seq))

    def clock(self) -> float:
        """The host clock (0.0 when disabled): a tick's start for
        ``tick_done``, a request's stamps."""
        return self._clock() if self.enabled else 0.0

    def tick_start(self) -> float:
        """``clock()`` that also opens the tick as the outermost host
        interval idle is charged to (``idle.tick``)."""
        t0 = self.clock()
        if self.timing:
            self._seq += 1
            self._tick_open = (t0, self._seq)
        return t0

    def tick_done(self, tick: int, t0: float) -> None:
        """Close the whole-tick wall span opened by ``clock()``."""
        if not self.enabled:
            return
        t1 = self._clock()
        dur = t1 - t0
        self._tick_n += 1
        self._tick_total_s += dur
        self.tick_times.append((tick, dur))
        if self._tick_open is not None:
            self._hosts.append((t0, t1, "tick", self._tick_open[1]))
            self._tick_open = None
            self._tick_end = t1
            self._map()

    def reset(self) -> None:
        """Drop everything: rings, aggregates, epoch (a warm-up
        boundary). Device work in flight stays pending; what was settled
        is mapped first, and dropped with the rest."""
        if self.timing:
            self._map()
        self.events.clear()
        self.spans.clear()
        self.device_spans.clear()
        self.tick_times.clear()
        self.dropped_events = 0
        self.counters.clear()
        self.shed_by_class.clear()
        self.preemption_log.clear()
        self._span_agg.clear()
        self._tick_n = 0
        self._tick_total_s = 0.0
        self._epoch = self._clock()

    # -- queries --------------------------------------------------------------

    def events_of(self, kind: Optional[str] = None) -> List[Tuple]:
        """Ring events, optionally of one kind (the recent window only:
        the aggregates hold the exact whole-run totals)."""
        if kind is None:
            return list(self.events)
        assert kind in EVENT_KINDS, kind
        return [e for e in self.events if e[2] == kind]

    def tick_stats(self) -> Dict[str, float]:
        """Whole-tick wall-time histogram. ``mean_s``/``total_s`` are
        exact over the run; percentiles cover the ring window."""
        if not self._tick_n:
            return {"n": 0, "total_s": 0.0, "mean_s": 0.0,
                    "p50_s": 0.0, "p99_s": 0.0, "max_s": 0.0}
        durs = [d for _, d in self.tick_times]
        return {"n": self._tick_n,
                "total_s": self._tick_total_s,
                "mean_s": self._tick_total_s / self._tick_n,
                "p50_s": float(np.percentile(durs, 50)),
                "p99_s": float(np.percentile(durs, 99)),
                "max_s": float(max(durs))}

    def span_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregates, first runs apart: ``compile_*`` is
        the steps' builds, ``execute_mean_s`` the steady-state mean. The
        device's idle is charged up to the reading first, where nothing
        is in flight (``_flush_idle``), after what was settled is mapped."""
        if self.timing:
            self._map()
            self._flush_idle()
        out = {}
        for name, (n, total, mx, cn, cs) in self._span_agg.items():
            en = n - cn
            out[name] = {
                "n": n, "total_s": total, "mean_s": total / n, "max_s": mx,
                "compile_n": cn, "compile_s": cs, "execute_n": en,
                "execute_mean_s": (total - cs) / en if en else 0.0,
            }
        return out

    # -- exporters ------------------------------------------------------------

    def metrics(self) -> Dict[str, Any]:
        """Everything as one flat scalar dict. Keys: ``count_*``
        aggregates, ``tick_*`` histogram, ``span_<name>_*`` stats."""
        out: Dict[str, Any] = {
            "schema_version": self.schema_version,
            "enabled": self.enabled,
            "events_in_ring": len(self.events),
            "events_dropped": self.dropped_events,
        }
        for k in sorted(self.counters):
            out[f"count_{k}"] = self.counters[k]
        for k, v in self.tick_stats().items():
            out[f"tick_{k}"] = v
        for name, st in sorted(self.span_stats().items()):
            out[f"span_{name}_n"] = st["n"]
            out[f"span_{name}_mean_s"] = st["mean_s"]
            out[f"span_{name}_compile_n"] = st["compile_n"]
            out[f"span_{name}_execute_mean_s"] = st["execute_mean_s"]
        return out

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace/Perfetto JSON (the ``traceEvents`` array format).

        One track (tid) per engine phase (``phase:decode``, ...) carries
        the wall-clock spans as complete events (ph="X"), each child span
        nested in its parent's track; per-slot tracks (``slot:0``, ...)
        carry slot-attributed spans (prefill chunks and their children)
        and the decision events as instants (ph="i"); the ``device`` track
        carries the device spans and the idle gaps by the host span they
        were charged to. Counter tracks (ph="C")
        rebuild pool occupancy, queue depth and the live speculation width
        from the decision events. Timestamps are microseconds from the
        telemetry's epoch. Write it with ``json.dump`` and open it at
        ui.perfetto.dev or chrome://tracing."""
        tev = []
        for name, t0, dur, tick, slot, comp, parent, rid, track in self.spans:
            args = {"tick": tick, "compile": comp, "parent": parent}
            if rid is not None:
                args["rid"] = rid
            tev.append({"name": name, "ph": "X", "pid": 0, "tid": track,
                        "ts": t0 * 1e6, "dur": dur * 1e6, "args": args})
        for name, t0, dur, tick, slot in self.device_spans:
            tev.append({"name": name, "ph": "X", "pid": 0, "tid": "device",
                        "ts": t0 * 1e6, "dur": dur * 1e6,
                        "args": {"tick": tick, "slot": slot}})
        # Counter tracks, integrated from the decision events in ring
        # order. The ring may have evicted the start of the run, so the
        # integrals are clamped at zero: the aggregates hold the totals.
        pool = queue = 0
        for t, tick, kind, payload in self.events:
            slot = payload.get("slot")
            tid = f"slot:{slot}" if slot is not None else "phase:events"
            tev.append({"name": kind, "ph": "i", "s": "t", "pid": 0,
                        "tid": tid, "ts": t * 1e6,
                        "args": dict(payload, tick=tick)})
            ts = t * 1e6
            if kind in ("page_alloc", "page_free"):
                pool += payload.get("n", 0) * (1 if kind == "page_alloc"
                                               else -1)
                pool = max(0, pool)
                tev.append({"name": "pool_pages", "ph": "C", "pid": 0,
                            "ts": ts, "args": {"pages": pool}})
            elif kind in ("submit", "admit", "shed", "preempt"):
                queue += 1 if kind in ("submit", "preempt") else -1
                queue = max(0, queue)
                tev.append({"name": "queue_depth", "ph": "C", "pid": 0,
                            "ts": ts, "args": {"requests": queue}})
            elif kind == "spec_verify":
                tev.append({"name": "spec_k_live", "ph": "C", "pid": 0,
                            "ts": ts,
                            "args": {"k": payload.get("proposed", 0)}})
            elif kind == "probe_tick":
                tev.append({"name": "spec_k_live", "ph": "C", "pid": 0,
                            "ts": ts, "args": {"k": 1}})
        return {"traceEvents": tev, "displayTimeUnit": "ms",
                "otherData": {"schema_version": self.schema_version}}


# -- model against measured ---------------------------------------------------


def drift_report(engine, persist: bool = False) -> Dict[str, Any]:
    """The serving cost models (``core.autotune``) against the execute
    spans this paged engine measured, for its own configuration:

    * ``decode`` — the mean decode span against ``paged_decode_model``'s
      ``paged_s`` at the run's mean context length and active slots
      (counted on the host each tick: no device read);
    * ``prefill_chunk`` — the chunk replay's mean device time
      (``prefill_chunk.replay.device``, a CUDA engine with telemetry on)
      against one chunk of ``prefill_chunk_model``; where no device span
      was measured, the mean chunk span (on the card the launch alone);
      ``span`` says which;
    * ``spec_verify`` — the mean verify span against
      ``spec_decode_model``'s ``spec_tick_s`` at the measured accept rate.

    A component is present when its spans were measured. Each has
    ``measured_s``, ``modeled_s`` and ``ratio`` (``autotune.drift_ratio``)
    under the constants the engine priced its decisions with
    (``engine.constants``), and ``modeled_default_s``/``ratio_default``
    under the hand-set defaults. The report also says which set was active
    (``constants``) and carries ``autotune.calibration_report``. With
    ``persist=True`` the measurements go into the tuning cache under the
    ``serve_measured:`` namespace. On the card a decode or verify span
    ends with the step's read of its picks (device time included)."""
    from repro_torch.core import autotune
    from repro_torch.models import transformer as T

    assert engine.pool is not None, "drift_report needs a paged engine"
    tel = engine.telemetry
    cfg, scfg = engine.cfg, engine.scfg
    stats = tel.span_stats()
    c = tel.counters
    in_bytes = cfg.dtype.itemsize

    def mean_geom(rows_key: str, slots_key: str, n_spans: int):
        slot_ticks = c.get(slots_key, 0)
        rows = c.get(rows_key, 0)
        mean_len = max(1, int(round(rows / max(1, slot_ticks))))
        mean_slots = max(1, int(round(slot_ticks / max(1, n_spans))))
        return mean_len, mean_slots

    out: Dict[str, Any] = {"schema_version": TRACE_SCHEMA_VERSION}
    geom = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.dhead, page_size=scfg.page_size,
                in_bytes=in_bytes)
    const = getattr(engine, "constants", None)
    if const is None:
        const = autotune.resolve_constants(backend=engine.device.type)

    def cell(measured, model_fn):
        """Measured against the model under the engine's constants (the
        headline) and under the defaults."""
        modeled = model_fn(constants=const)
        modeled_default = modeled if const.source == "default" \
            else model_fn(constants=autotune.DEFAULT_CONSTANTS)
        return {
            "measured_s": measured, "modeled_s": modeled,
            "ratio": autotune.drift_ratio(measured, modeled),
            "modeled_default_s": modeled_default,
            "ratio_default": autotune.drift_ratio(measured,
                                                  modeled_default)}

    dec = stats.get("decode")
    if dec and dec["execute_n"]:
        mean_len, mean_slots = mean_geom(
            "decode_context_rows", "decode_slot_ticks", dec["n"])
        out["decode"] = dict(cell(
            dec["execute_mean_s"],
            lambda **kw: autotune.paged_decode_model(
                scfg.max_len, [mean_len] * mean_slots, **geom,
                **kw)["paged_s"]),
            n_spans=dec["execute_n"], mean_context=mean_len,
            mean_slots=mean_slots)

    pc_span = "prefill_chunk.replay.device"
    pc = stats.get(pc_span)
    if not pc:
        pc_span = "prefill_chunk"
        pc = stats.get(pc_span)
    if pc and pc["execute_n"]:
        out["prefill_chunk"] = dict(cell(
            pc["execute_mean_s"],
            lambda **kw: autotune.prefill_chunk_model(
                engine.chunk, engine.chunk, **geom, **kw)["prefill_s"]),
            n_spans=pc["execute_n"], chunk=engine.chunk, span=pc_span)

    sv = stats.get("spec_verify")
    if sv and sv["execute_n"] and engine.spec_k:
        mean_len, mean_slots = mean_geom(
            "verify_context_rows", "verify_slot_ticks", sv["n"])
        proposed = c.get("spec_proposed", 0)
        rate = c.get("spec_accepted", 0) / proposed if proposed else 0.0
        out["spec_verify"] = dict(cell(
            sv["execute_mean_s"],
            lambda **kw: autotune.spec_decode_model(
                [mean_len] * mean_slots, k=engine.spec_k,
                accept_rate=rate,
                param_bytes=T.active_param_count(cfg) * float(in_bytes),
                **geom, **kw)["spec_tick_s"]),
            n_spans=sv["execute_n"], spec_k=engine.spec_k,
            accept_rate=rate)

    out["constants"] = {"source": const.source, "backend": const.backend,
                        "mesh": const.mesh, "timestamp": const.timestamp}
    out["calibration"] = autotune.calibration_report(
        backend=engine.device.type)

    if persist:
        ident = (f"{cfg.n_heads}h{cfg.n_kv_heads}kv{cfg.dhead}d"
                 f":page{scfg.page_size}:chunk{engine.chunk}")
        for comp in ("decode", "prefill_chunk", "spec_verify"):
            row = out.get(comp)
            if row is None:
                continue
            autotune.record_serve_measurement(f"{comp}:{ident}", {
                "time_s": row["measured_s"],
                "modeled_s": row["modeled_s"],
                "ratio": row["ratio"],
                "n": row["n_spans"],
                "source": "serve.telemetry",
            })
    return out
