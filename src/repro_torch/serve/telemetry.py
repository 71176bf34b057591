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
  and chunk steps and the host's scheduling phases, with a step's first
  run (its build: a capture or a first eager run) flagged ``compile``,
  plus a per-tick wall-time histogram (p50/p99). Spans measure
  host-observed time: the launch, plus whatever synchronisation the
  engine already performs. No synchronisation or host<->device transfer
  is added for telemetry, so a traced engine's streams equal an untraced
  engine's.
* **Exporters** — ``chrome_trace()`` emits a Chrome-trace/Perfetto JSON
  timeline (one track per engine phase, one per slot); ``metrics()``
  flattens everything into one scalar dict.
* **Drift** — ``drift_report(engine)`` holds the serving cost models
  (``core.autotune``) against the engine's measured spans.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

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


class _Span:
    """Context manager recording one wall-clock span. ``compile`` is set
    by the caller, inside the block, from the engine's build counters."""

    __slots__ = ("_tel", "name", "tick", "slot", "compile", "_t0")

    def __init__(self, tel: "Telemetry", name: str, tick: int,
                 slot: Optional[int]):
        self._tel = tel
        self.name = name
        self.tick = tick
        self.slot = slot
        self.compile = False

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._tel._record_span(self, self._t0,
                               time.perf_counter() - self._t0)


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


class Telemetry:
    """One engine's observability state: event ring, aggregates, spans.

    Aggregates (``counters``, ``shed_by_class``, ``preemption_log``) are
    updated by every ``emit``/``count`` call whether or not ``enabled``;
    they back the engine's counter views and must stay exact. The ring
    buffers (events, spans, tick times) and the ``perf_counter`` reads
    are what ``enabled`` gates."""

    def __init__(self, enabled: bool = True, capacity: int = 4096):
        assert capacity >= 1, capacity
        self.enabled = enabled
        self.capacity = capacity
        self.schema_version = TRACE_SCHEMA_VERSION
        # Ring entries: (t_rel_s, tick, kind, payload_dict).
        self.events: deque = deque(maxlen=capacity)
        # Ring entries: (name, t0_rel_s, dur_s, tick, slot, compile).
        self.spans: deque = deque(maxlen=capacity)
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
        self._epoch = time.perf_counter()

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
        self.events.append(
            (time.perf_counter() - self._epoch, tick, kind, payload))

    def span(self, name: str, tick: int, slot: Optional[int] = None):
        """Wall-clock span context manager; a no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, tick, slot)

    def _record_span(self, sp: _Span, t0: float, dur: float) -> None:
        agg = self._span_agg.get(sp.name)
        if agg is None:
            agg = self._span_agg[sp.name] = [0, 0.0, 0.0, 0, 0.0]
        agg[0] += 1
        agg[1] += dur
        agg[2] = max(agg[2], dur)
        if sp.compile:
            agg[3] += 1
            agg[4] += dur
        self.spans.append((sp.name, t0 - self._epoch, dur, sp.tick,
                           sp.slot, sp.compile))

    def clock(self) -> float:
        """Tick-start timestamp (0.0 when disabled; tick_done ignores)."""
        return time.perf_counter() if self.enabled else 0.0

    def tick_done(self, tick: int, t0: float) -> None:
        """Close the whole-tick wall span opened by ``clock()``."""
        if not self.enabled:
            return
        dur = time.perf_counter() - t0
        self._tick_n += 1
        self._tick_total_s += dur
        self.tick_times.append((tick, dur))

    def reset(self) -> None:
        """Drop everything: rings, aggregates, epoch (a warm-up
        boundary)."""
        self.events.clear()
        self.spans.clear()
        self.tick_times.clear()
        self.dropped_events = 0
        self.counters.clear()
        self.shed_by_class.clear()
        self.preemption_log.clear()
        self._span_agg.clear()
        self._tick_n = 0
        self._tick_total_s = 0.0
        self._epoch = time.perf_counter()

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
        the steps' builds, ``execute_mean_s`` the steady-state mean."""
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
        the wall-clock spans as complete events (ph="X"); per-slot tracks
        (``slot:0``, ...) carry slot-attributed spans (prefill chunks) and
        the decision events as instants (ph="i"). Counter tracks (ph="C")
        rebuild pool occupancy, queue depth and the live speculation width
        from the decision events. Timestamps are microseconds from the
        telemetry's epoch. Write it with ``json.dump`` and open it at
        ui.perfetto.dev or chrome://tracing."""
        tev = []
        for name, t0, dur, tick, slot, comp in self.spans:
            tid = f"slot:{slot}" if slot is not None else f"phase:{name}"
            tev.append({"name": name, "ph": "X", "pid": 0, "tid": tid,
                        "ts": t0 * 1e6, "dur": dur * 1e6,
                        "args": {"tick": tick, "compile": comp}})
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
    * ``prefill_chunk`` — the mean chunk span against one chunk of
      ``prefill_chunk_model``;
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
    ends with the step's read of its picks (device time included); a
    chunk span is the launch alone."""
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

    pc = stats.get("prefill_chunk")
    if pc and pc["execute_n"]:
        out["prefill_chunk"] = dict(cell(
            pc["execute_mean_s"],
            lambda **kw: autotune.prefill_chunk_model(
                engine.chunk, engine.chunk, **geom, **kw)["prefill_s"]),
            n_spans=pc["execute_n"], chunk=engine.chunk)

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
