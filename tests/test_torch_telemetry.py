"""Telemetry of the PyTorch port's engine (``repro_torch/serve/telemetry.py``).

The port's copy of the reference's observability contract: tracing is
observational (a traced engine serves what an untraced one does on every
path: greedy, sampled, speculative, faulted, preempting); the event trace
reconciles with the counter views and the page pool's conservation law;
ring eviction bounds memory without touching the aggregates; a step's
first run is flagged exactly once; the exporters emit valid JSON. The
``Telemetry`` class itself is held to the reference's on the same calls.
Wall-clock readings are checked for presence, finiteness, sign and order
only, never as a ratio of two times.
"""

import json
import math
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve import telemetry as jtelemetry

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.serve import graphs, telemetry, traffic
from repro_torch.serve.engine import (Request, ServeConfig, ServingEngine,
                                      SLOClass)
from repro_torch.serve.faults import FaultInjector, canonical_schedule
from repro_torch.serve.paged import PageAllocator

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these smoke-size tensors: the suite's
    parallel workers would otherwise oversubscribe the cores, and small
    ops slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """The smoke config on the reference's weights, carried across."""
    cfg = configs.get_smoke("qwen3-4b")
    jparams = JT.init_params(jax.random.PRNGKey(0),
                             jconfigs.get_smoke("qwen3-4b"))
    return cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")


def _scfg(**kw):
    base = dict(max_len=64, batch=2, eos_id=-1, paged=True, page_size=8,
                chunk_size=8)
    base.update(kw)
    return ServeConfig(**base)


def _tcfg(**kw):
    base = dict(rate=2.0, n_requests=24, seed=7, vocab=128,
                classes=(traffic.TrafficClass(
                    "default", prompt_lo=4, prompt_hi=20,
                    out_lo=2, out_hi=6),))
    base.update(kw)
    return traffic.TrafficConfig(**base)


def _overload_kw():
    """Engine knobs that exercise shed, preemption and degradation."""
    return dict(n_pages=17,
                classes=(SLOClass("default", ttft_slo=8, tpot_slo=4.0),),
                max_queue=4, max_preemptions=3, degrade=True)


def _spec_kw():
    return dict(_overload_kw(), spec_k=2, draft="ngram")


def _faults():
    return FaultInjector(canonical_schedule(t0=4, dwell=8, gap=6))


def _run(model, scfg_kw, tcfg_kw, injector_fn=None):
    cfg, params = model
    eng = ServingEngine(params, cfg, _scfg(**scfg_kw), device="cpu")
    arr = traffic.TrafficGenerator(_tcfg(**tcfg_kw)).arrivals()
    inj = injector_fn() if injector_fn else None
    res = traffic.run_open_loop(eng, arr, max_ticks=2000, injector=inj)
    if inj is not None:
        inj.finish(eng)
    assert res["unresolved"] == []
    return eng, arr


# ----------------------------------------------------------------------------
# A traced engine serves what an untraced one does
# ----------------------------------------------------------------------------

PARITY = {
    "greedy_overload": (_overload_kw(), dict(rate=3.0, n_requests=24), None),
    "sampled": (dict(_overload_kw(), temperature=0.7, seed=3),
                dict(rate=2.0, n_requests=16), None),
    "spec_plus_faults": (_spec_kw(), dict(rate=1.5, n_requests=24), _faults),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_traced_is_bit_identical(model, case):
    scfg_kw, tcfg_kw, inj = PARITY[case]
    traced, _ = _run(model, dict(scfg_kw, telemetry=True), tcfg_kw, inj)
    plain, _ = _run(model, dict(scfg_kw, telemetry=False), tcfg_kw, inj)
    assert traced.outcome == plain.outcome
    assert traced.finished == plain.finished
    assert traced.ticks == plain.ticks
    st = traced.telemetry.span_stats()
    assert {"decode.load", "decode.launch", "decode.read",
            "prefill_chunk.load", "prefill_chunk.launch", "pages",
            "record"} <= set(st)
    assert traced.telemetry.counters["host_syncs"] == \
        plain.telemetry.counters["host_syncs"] > 0
    c = traced.telemetry.counters
    if case == "greedy_overload":
        assert c.get("shed", 0) >= 1 and c.get("degrade_enter", 0) >= 1
    if case == "spec_plus_faults":
        assert c.get("spec_verify", 0) >= 1 and c.get("preempt", 0) >= 1


# ----------------------------------------------------------------------------
# The trace is the bookkeeping
# ----------------------------------------------------------------------------

def test_outcome_accounting_reconciles_with_trace(model):
    """Every submitted rid reaches exactly one terminal event, and the
    counter views agree with the ring event by event (nothing evicted)."""
    eng, arr = _run(model, dict(_spec_kw(), trace_capacity=65536),
                    dict(rate=1.5, n_requests=24), _faults)
    assert eng.preemptions >= 1 and eng.admission_rejections >= 1
    tel = eng.telemetry
    assert tel.dropped_events == 0
    assert len(tel.events_of("submit")) == len(arr)
    terminal = {}
    for _, _, kind, p in tel.events_of("shed") + tel.events_of("finish"):
        assert p["rid"] not in terminal, f"double terminal for {p['rid']}"
        terminal[p["rid"]] = kind
    assert set(terminal) == {a.rid for a in arr}
    assert len(tel.events_of("shed")) == tel.counters["shed"] \
        == sum(eng.shed_by_class.values())
    preempts = tel.events_of("preempt")
    assert len(preempts) == eng.preemptions == len(eng.preemption_log)
    for (_, _, _, p), (rid, rclass, n_gen) in zip(preempts,
                                                  eng.preemption_log):
        assert (p["rid"], p["rclass"], p["n_generated"]) == \
            (rid, rclass, n_gen)
    assert len(tel.events_of("admit_hold")) == eng.admission_rejections
    ent, ext = tel.events_of("degrade_enter"), tel.events_of("degrade_exit")
    assert len(ent) - len(ext) in (0, 1)
    assert eng.downshifts == len(ent)


def test_page_events_reconcile_with_pool_conservation(model):
    eng, _ = _run(model, dict(_overload_kw(), trace_capacity=65536),
                  dict(rate=3.0, n_requests=24))
    tel = eng.telemetry
    allocd = sum(p["n"] for _, _, _, p in tel.events_of("page_alloc"))
    freed = sum(p["n"] for _, _, _, p in tel.events_of("page_free"))
    assert allocd == eng.pool.pages_allocated
    assert freed == eng.pool.pages_freed
    assert eng.pool.pages_allocated - eng.pool.pages_freed \
        == eng.pool.pages_in_use == 0
    occ = eng.pool.occupancy()
    assert occ["pages_allocated"] == allocd
    assert occ["pages_freed"] == freed
    assert occ["high_water"] >= 1


def test_spec_verify_events_reconcile(model):
    eng, _ = _run(model, dict(_spec_kw(), trace_capacity=65536),
                  dict(rate=1.5, n_requests=16))
    tel = eng.telemetry
    ev = tel.events_of("spec_verify")
    assert len(ev) >= 1
    assert sum(p["proposed"] for _, _, _, p in ev) == \
        tel.counters["spec_proposed"] == eng.spec_proposed
    assert sum(p["accepted"] for _, _, _, p in ev) == eng.spec_accepted
    assert sum(p["emitted"] for _, _, _, p in ev) == eng.spec_emitted
    assert len(ev) == eng.spec_ticks


# ----------------------------------------------------------------------------
# The ring bounds memory; the aggregates stay exact
# ----------------------------------------------------------------------------

def test_ring_eviction_keeps_aggregates_exact(model):
    small, _ = _run(model, dict(_overload_kw(), trace_capacity=16),
                    dict(rate=3.0, n_requests=24))
    big, _ = _run(model, dict(_overload_kw(), trace_capacity=65536),
                  dict(rate=3.0, n_requests=24))
    assert small.telemetry.dropped_events > 0
    assert len(small.telemetry.events) == 16
    assert list(small.telemetry.events)[-1][1:] == \
        list(big.telemetry.events)[-1][1:]
    assert small.telemetry.counters == big.telemetry.counters
    assert small.shed_by_class == big.shed_by_class
    assert small.preemption_log == big.preemption_log


def test_disabled_telemetry_keeps_counters_exact(model):
    off, _ = _run(model, dict(_overload_kw(), telemetry=False),
                  dict(rate=3.0, n_requests=24))
    on, _ = _run(model, _overload_kw(), dict(rate=3.0, n_requests=24))
    assert len(off.telemetry.events) == 0
    assert len(off.telemetry.spans) == 0
    assert off.telemetry.tick_stats()["n"] == 0
    assert off.telemetry.counters == on.telemetry.counters
    assert off.admission_rejections == on.admission_rejections
    assert off.shed_by_class == on.shed_by_class


def test_counter_views_are_writable(model):
    """A counter view is read and written through the aggregates (a
    warm-up boundary zeroes them)."""
    eng, _ = _run(model, _overload_kw(), dict(rate=3.0, n_requests=12))
    assert eng.telemetry.counters["shed"] >= 1
    eng.admission_rejections = 0
    eng.preemptions = 5
    assert eng.telemetry.counters["admit_hold"] == 0
    assert eng.telemetry.counters["preempt"] == eng.preemptions == 5


# ----------------------------------------------------------------------------
# Spans: each step's first run flagged once; the tick histogram
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [0, 2])
def test_compile_flags_and_tick_histogram(model, spec_k):
    """One decode (or verify) step and one chunk step: one first-run span
    each, the build counters at 1, and a speculative engine that never
    degrades never builds a decode step; the tick histogram counts every
    tick, its readings positive, finite and ordered."""
    cfg, params = model
    eng = ServingEngine(params, cfg, _scfg(n_pages=17, spec_k=spec_k),
                        device="cpu")
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=np.arange(
            3, 3 + 9 + rid, dtype=np.int32), max_new=4))
    eng.run_until_drained()
    st = eng.telemetry.span_stats()
    step = "spec_verify" if spec_k else "decode"
    assert st[step]["compile_n"] == 1
    assert (eng.verify_traces, eng.decode_traces) == \
        ((1, 0) if spec_k else (0, 1))
    assert st["prefill_chunk"]["compile_n"] == 1
    assert eng.prefill_traces == {8: 1}
    assert st[step]["execute_n"] == st[step]["n"] - 1
    assert st[step]["execute_mean_s"] > 0
    ts = eng.telemetry.tick_stats()
    assert ts["n"] == eng.ticks
    assert all(math.isfinite(ts[k]) for k in ("p50_s", "p99_s", "mean_s"))
    assert ts["p99_s"] >= ts["p50_s"] > 0
    assert ts["total_s"] == pytest.approx(ts["mean_s"] * ts["n"])


def test_contiguous_admission_span(model):
    """The contiguous engine's admission runs under ``prefill_bucket``
    spans, one first run flagged a bucket."""
    cfg, params = model
    eng = ServingEngine(params, cfg, ServeConfig(max_len=64, batch=2,
                                                 eos_id=-1), device="cpu")
    for rid, n in enumerate((5, 6, 20)):
        eng.submit(Request(rid=rid, prompt=np.arange(3, 3 + n,
                                                     dtype=np.int32),
                           max_new=3))
    eng.run_until_drained()
    st = eng.telemetry.span_stats()
    assert st["prefill_bucket"]["n"] == 3
    assert st["prefill_bucket"]["compile_n"] == len(eng.prefill_traces) == 2
    assert [p["slot"] for _, _, _, p in
            eng.telemetry.events_of("admit")] == [0, 1, 0]


# ----------------------------------------------------------------------------
# Exporters
# ----------------------------------------------------------------------------

def test_chrome_trace_is_valid_json_with_tracks(model):
    eng, _ = _run(model, _overload_kw(), dict(rate=2.0, n_requests=12))
    tr = eng.telemetry.chrome_trace()
    back = json.loads(json.dumps(tr))     # a numpy leak would raise here
    assert back["otherData"]["schema_version"] == \
        telemetry.TRACE_SCHEMA_VERSION
    evs = back["traceEvents"]
    assert evs
    tracks = {e["tid"] for e in evs if e["ph"] == "X"}
    assert {"phase:decode", "phase:admit", "phase:prefill"} <= tracks
    assert any(t.startswith("slot:") for t in tracks)   # prefill chunks
    counters = {e["name"] for e in evs if e["ph"] == "C"}
    assert {"pool_pages", "queue_depth"} <= counters
    for e in evs:
        assert e["ph"] in ("X", "i", "C")
        assert isinstance(e["ts"], float)
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
        if e["ph"] == "C":
            (val,) = e["args"].values()
            assert isinstance(val, int) and val >= 0


def test_metrics_flat_and_summary_wall_clock(model):
    tcls = (traffic.TrafficClass("default", prompt_lo=4, prompt_hi=20,
                                 out_lo=2, out_hi=6,
                                 ttft_ms=1e6, tpot_ms=1e6),)
    eng, arr = _run(model, _overload_kw(),
                    dict(rate=2.0, n_requests=12, classes=tcls))
    m = eng.telemetry.metrics()
    assert m["schema_version"] == telemetry.TRACE_SCHEMA_VERSION
    assert m["enabled"] is True
    assert m["count_admit"] >= 1
    assert m["span_decode_n"] >= 1
    for v in m.values():
        assert isinstance(v, (bool, int, float, str)), v
    s = traffic.summarize(eng, arr, classes=tcls)
    assert s["tick_wall_s_mean"] > 0
    assert s["tick_wall_s_p99"] >= s["tick_wall_s_p50"] > 0
    d = s["by_class"]["default"]
    assert d["ttft_ms_p50"] == pytest.approx(
        d["ttft_p50"] * s["tick_wall_s_mean"] * 1e3)
    assert d["ttft_ms_slo_attainment"] == 1.0
    assert d["tpot_ms_slo_attainment"] == 1.0


def test_traffic_class_rejects_nonpositive_ms_targets():
    with pytest.raises(AssertionError):
        traffic.TrafficClass("x", ttft_ms=0.0)
    with pytest.raises(AssertionError):
        traffic.TrafficClass("x", tpot_ms=-1.0)


# ----------------------------------------------------------------------------
# The Telemetry class and the allocator's counters (no model)
# ----------------------------------------------------------------------------

def test_schema_and_kinds_equal_the_reference():
    assert telemetry.TRACE_SCHEMA_VERSION == jtelemetry.TRACE_SCHEMA_VERSION
    assert telemetry.EVENT_KINDS == jtelemetry.EVENT_KINDS


def test_aggregates_equal_the_reference_on_the_same_calls():
    """The same emits and counts, numpy scalars among them, through both
    classes: equal aggregates, ring payloads and metric keys."""
    calls = [("emit", 1, "submit", dict(rid=0, rclass="a", prompt_rows=3,
                                        max_new=4)),
             ("emit", 1, "shed", dict(rid=1, rclass="b",
                                      reason="queue_full")),
             ("emit", 2, "preempt", dict(rid=0, rclass="a",
                                         n_generated=np.int64(2))),
             ("emit", 3, "spec_verify", dict(rid=0, slot=1,
                                             proposed=np.int32(2),
                                             accepted=1, emitted=2)),
             ("count", "degraded_tick", 1), ("count", "decode_slot_ticks", 3),
             ("emit", 4, "page_free", dict(slot=1, n=3))]
    tels = [telemetry.Telemetry(capacity=4), jtelemetry.Telemetry(capacity=4)]
    for tel in tels:
        for op, *args in calls:
            if op == "emit":
                tel.emit(args[0], args[1], **args[2])
            else:
                tel.count(*args)
    port, ref = tels
    assert port.counters == ref.counters
    assert port.shed_by_class == ref.shed_by_class
    assert port.preemption_log == ref.preemption_log
    assert port.dropped_events == ref.dropped_events == 1
    assert [e[1:] for e in port.events] == [e[1:] for e in ref.events]
    assert all(type(v) is int for e in port.events for v in e[3].values()
               if not isinstance(v, str))
    assert sorted(port.metrics()) == sorted(ref.metrics())


def test_emit_rejects_unknown_kind():
    tel = telemetry.Telemetry()
    with pytest.raises(AssertionError):
        tel.emit(0, "not_a_kind", rid=1)


def test_reset_clears_rings_and_aggregates():
    tel = telemetry.Telemetry(capacity=4)
    for i in range(6):
        tel.emit(i, "admit", rid=i, rclass="default")
    with tel.span("decode", 0):
        pass
    tel.tick_done(0, tel.clock())
    assert tel.dropped_events == 2
    tel.reset()
    assert len(tel.events) == 0 and len(tel.spans) == 0
    assert tel.dropped_events == 0
    assert tel.counters == {} and tel.tick_stats()["n"] == 0


def test_page_allocator_cumulative_counters():
    pool = PageAllocator(n_pages=9, page_size=8)
    pool.alloc(0, 3)
    pool.alloc(1, 2)
    pool.free_slot(0)
    pool.alloc(2, 4)
    assert pool.pages_allocated == 9
    assert pool.pages_freed == 3
    assert pool.pages_allocated - pool.pages_freed == pool.pages_in_use == 6
    assert pool.occupancy()["pages_allocated"] == 9
    assert pool.occupancy()["pages_freed"] == 3


# ----------------------------------------------------------------------------
# Device spans, idle, host syncs, request stamps
# ----------------------------------------------------------------------------

class HostEvent:
    """A timing event on the host clock: what a CUDA event reads on a
    device that runs each piece of work as the host enqueues it (the CPU
    engine), so the device-span path runs end to end here."""

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, later):
        return (later.t - self.t) * 1e3


@pytest.fixture
def host_events(monkeypatch):
    """Engines built inside the test time device spans with ``HostEvent``
    (telemetry on): the CUDA engine's path, on the CPU."""
    init = telemetry.Telemetry.__init__

    def timed(self, *a, **kw):
        kw.setdefault("new_event", HostEvent)
        init(self, *a, **kw)

    monkeypatch.setattr(telemetry.Telemetry, "__init__", timed)


@pytest.mark.parametrize("case", sorted(PARITY))
def test_device_timed_is_bit_identical(model, host_events, case):
    """Device spans timed (events, settles, idle charged) on every path:
    the streams, outcomes and ticks of an untraced engine, and the busy
    and idle seconds tile the engine's device timeline."""
    scfg_kw, tcfg_kw, inj = PARITY[case]
    timed, _ = _run(model, dict(scfg_kw, telemetry=True), tcfg_kw, inj)
    plain, _ = _run(model, dict(scfg_kw, telemetry=False), tcfg_kw, inj)
    assert timed.telemetry.timing and not plain.telemetry.timing
    assert timed.outcome == plain.outcome
    assert timed.finished == plain.finished
    assert timed.ticks == plain.ticks
    assert timed.telemetry.counters == plain.telemetry.counters
    st = timed.telemetry.span_stats()
    step = "spec_verify" if timed.spec_k else "decode"
    assert {f"{step}.replay.device", "prefill_chunk.replay.device",
            f"{step}.load.device", "prefill_chunk.load.device",
            "idle.outside"} <= set(st)
    for name, v in st.items():
        if name.endswith(".device") or name.startswith("idle."):
            assert v["total_s"] >= 0.0 and v["compile_n"] == 0, name
    # One stream: the device spans follow one another, and the idle parts
    # fill the gaps between them, and the time from the last one to the
    # reading above, exactly.
    dev = sorted((t0, t0 + d, name) for name, t0, d, _, _ in
                 timed.telemetry.device_spans)
    busy = [(a, b) for a, b, name in dev if name.endswith(".device")]
    idle = [(a, b) for a, b, name in dev if name.startswith("idle.")]
    assert all(b1 <= a2 + 1e-9 for (_, b1), (a2, _) in zip(busy, busy[1:]))
    span = max(b for _, b, _ in dev) - busy[0][0]
    assert sum(b - a for a, b in busy + idle) == pytest.approx(span,
                                                               rel=1e-9)


def test_telemetry_off_times_nothing(model, host_events):
    """With telemetry off no step is timed (a captured graph would hold
    no event node), no span and no device span is recorded, and nothing
    is stamped; the host syncs are still counted."""
    cfg, params = model
    eng = ServingEngine(params, cfg, _scfg(telemetry=False), device="cpu")
    assert not eng.telemetry.timing
    assert all(s.timing is None and s.tel is None
               for s in (eng._decode, eng._chunk))
    reqs = [Request(rid=r, prompt=np.arange(3, 14, dtype=np.int32),
                    max_new=3) for r in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    tel = eng.telemetry
    assert len(tel.spans) == len(tel.device_spans) == 0
    assert tel.span_stats() == {} and tel._evq == [] and tel._hosts == []
    assert tel.counters["host_syncs"] > 0
    assert all(v == {} for v in eng.stamps.values())
    assert all(r.submit_t is None and r.admit_t is None
               and r.first_chunk_t is None and r.first_token_t is None
               for r in reqs)


def test_contiguous_prefill_is_device_timed(model, host_events):
    """A contiguous admission's forward is the device span
    ``prefill_bucket``, ended before the read that settles it: host-clock
    events map onto their own times, so the span is the forward's host
    time, inside the host span ``prefill_bucket``; busy and idle tile the
    device timeline."""
    cfg, params = model
    eng = ServingEngine(params, cfg, ServeConfig(max_len=64, batch=2,
                                                 eos_id=-1), device="cpu")
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=np.arange(
            3, 12 + 3 * rid, dtype=np.int32), max_new=3))
    eng.run_until_drained()
    tel = eng.telemetry
    st = tel.span_stats()
    dev, host = st["prefill_bucket.device"], st["prefill_bucket"]
    assert dev["n"] == host["n"] == 3
    assert 0 < dev["total_s"] <= host["total_s"]
    assert st["prefill_bucket.read"]["n"] == 3
    spans = {(tick, slot): (t0, t0 + d) for name, t0, d, tick, slot,
             *_ in tel.spans if name == "prefill_bucket"}
    for name, t0, d, tick, slot in tel.device_spans:
        if name == "prefill_bucket.device":
            lo, hi = spans[tick, slot]
            assert lo <= t0 and t0 + d <= hi + 1e-3
    evs = sorted((t0, t0 + d, name) for name, t0, d, _, _ in
                 tel.device_spans)
    busy = sum(b - a for a, b, n in evs if n.endswith(".device"))
    idle = sum(b - a for a, b, n in evs if n.startswith("idle."))
    assert busy + idle == pytest.approx(max(b for _, b, _ in evs)
                                        - evs[0][0], rel=1e-9)


def test_untimed_step_captures_as_before():
    """A step built without a timing telemetry keeps no telemetry, and
    one built with it on the CPU times its runs eagerly."""
    tel = telemetry.Telemetry(new_event=HostEvent)
    ran = []
    assert graphs.Step(lambda: ran.append(1), torch.device("cpu"),
                       True).timing is None
    step = graphs.Step(lambda: ran.append(1), torch.device("cpu"), True,
                       tel, "x.replay")
    assert step.timing == "eager"
    step(tick=3)
    tel.settle()
    assert ran == [1]           # on the CPU a step runs only when called
    assert tel.span_stats()["x.replay.device"]["n"] == 1


def test_spans_nest_under_their_parents(model):
    """Every span records the span open around it; a chunk's spans carry
    its rid and slot; the Chrome trace puts a child on its parent's
    track."""
    cfg, params = model
    eng = ServingEngine(params, cfg, _scfg(), device="cpu")
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=np.arange(
            3, 3 + 10 + 4 * rid, dtype=np.int32), max_new=3))
    eng.run_until_drained()
    parents = {}
    for name, _, _, _, slot, _, parent, rid, track in eng.telemetry.spans:
        parents.setdefault(name, set()).add(parent)
        if name.startswith("prefill_chunk"):
            assert rid in (0, 1, 2) and track == f"slot:{slot}"
    assert parents["decode.load"] == parents["decode.launch"] == \
        parents["decode.read"] == {"decode"}
    assert parents["prefill_chunk.load"] == \
        parents["prefill_chunk.launch"] == {"prefill_chunk"}
    assert parents["prefill_chunk"] == parents["prefill_chunk.read"] == \
        {"prefill"}
    assert parents["pages"] == {"admit", "prefill"}
    assert parents["record"] == {None, "prefill"}
    assert parents["decode"] == parents["admit"] == parents["prefill"] \
        == {None}
    tracks = {(e["name"], e["tid"]) for e in
              eng.telemetry.chrome_trace()["traceEvents"] if e["ph"] == "X"}
    assert ("decode.launch", "phase:decode") in tracks
    assert ("pages", "phase:prefill") in tracks
    for e in eng.telemetry.chrome_trace()["traceEvents"]:
        if e["ph"] == "X" and e["name"] == "prefill_chunk.load":
            assert e["args"]["parent"] == "prefill_chunk"
            assert e["args"]["rid"] in (0, 1, 2)


def _syncs_by_tick(eng, reqs):
    for r in reqs:
        eng.submit(r)
    out = []
    while eng.queue or any(s is not None for s in eng.slots):
        n0 = eng.telemetry.counters.get("host_syncs", 0)
        eng.tick()
        out.append(eng.telemetry.counters["host_syncs"] - n0)
    return out


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_host_syncs_count_the_call_sites(model, temperature):
    """A chunk uploads its tokens and table row (and, sampled, its key),
    a prompt's last chunk reads its token; a paged decode uploads the
    write positions, the table and the tokens (and, sampled, the rows'
    ids and indices) and reads its picks."""
    cfg, params = model
    sampled = temperature > 0
    eng = ServingEngine(params, cfg, _scfg(batch=1, temperature=temperature),
                        device="cpu")
    # 20 rows in chunks of 8: three chunk ticks, the last one decoding too.
    got = _syncs_by_tick(eng, [Request(rid=0, prompt=np.arange(
        3, 23, dtype=np.int32), max_new=4)])
    chunk = 2 + sampled
    decode = 4 + 2 * sampled
    assert got == [chunk, chunk, chunk + 1 + decode, decode, decode]


def test_host_syncs_count_the_contiguous_call_sites(model):
    """A contiguous admission uploads its prompt and reads its token; a
    contiguous decode uploads the write positions and the tokens and
    reads its picks."""
    cfg, params = model
    eng = ServingEngine(params, cfg, ServeConfig(max_len=64, batch=1,
                                                 eos_id=-1), device="cpu")
    got = _syncs_by_tick(eng, [Request(rid=0, prompt=np.arange(
        3, 12, dtype=np.int32), max_new=3)])
    assert got == [2 + 3, 3]


@pytest.mark.parametrize("paged", [True, False])
def test_request_stamps_are_ordered(model, paged):
    """submit_t <= admit_t <= first_chunk_t <= first_token_t <= the host
    clock after the tick that delivered the first token; ``summarize``
    reads its wall-clock tails from the engine's copy of them."""
    cfg, params = model
    scfg = _scfg() if paged else ServeConfig(max_len=64, batch=2, eos_id=-1)
    eng = ServingEngine(params, cfg, scfg, device="cpu")
    reqs = [Request(rid=r, prompt=np.arange(3, 12 + 3 * r, dtype=np.int32),
                    max_new=3) for r in range(4)]
    seen = {}
    for r in reqs:
        eng.submit(r)
    while eng.queue or any(s is not None for s in eng.slots):
        eng.tick()
        now = time.perf_counter()
        for r in reqs:
            if r.generated and r.rid not in seen:
                seen[r.rid] = now
    for r in reqs:
        assert r.submit_t <= r.admit_t <= r.first_chunk_t \
            <= r.first_token_t <= seen[r.rid]
    for field, at in eng.stamps.items():
        assert at == {r.rid: getattr(r, field) for r in reqs}, field
    # Four requests over two slots: the last two waited in the queue.
    assert reqs[3].admit_t > reqs[0].first_token_t
    arr = [traffic.Arrival(rid=r.rid, tick=0, prompt=r.prompt,
                           max_new=r.max_new, rclass="default")
           for r in reqs]
    s = traffic.summarize(eng, arr)
    waits = [(r.admit_t - r.submit_t) * 1e3 for r in reqs]
    chunks = [(r.first_chunk_t - r.submit_t) * 1e3 for r in reqs]
    ttfts = [(r.first_token_t - r.submit_t) * 1e3 for r in reqs]
    for q in (50, 95, 99):
        assert s[f"queue_wait_ms_p{q}"] == pytest.approx(
            np.percentile(waits, q))
        assert s[f"prefill_wait_ms_p{q}"] == pytest.approx(
            np.percentile(chunks, q))
        assert s[f"ttft_wall_ms_p{q}"] == pytest.approx(
            np.percentile(ttfts, q))
    off = ServingEngine(params, cfg, dataclasses_replace(scfg,
                                                         telemetry=False),
                        device="cpu")
    for r in reqs:
        off.submit(Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new))
    off.run_until_drained()
    assert not any(k.startswith(("queue_wait", "prefill_wait", "ttft_wall"))
                   for k in traffic.summarize(off, arr))


def test_paged_prefill_wait_counts_other_prompts_chunks(model):
    """One slot's prompt waits for its first chunk while a budget of one
    chunk a tick serves the other prompt first: admitted together, their
    first chunks are a tick apart."""
    cfg, params = model
    eng = ServingEngine(params, cfg, _scfg(batch=2, prefill_chunks_per_tick=1),
                        device="cpu")
    reqs = [Request(rid=r, prompt=np.arange(3, 23, dtype=np.int32),
                    max_new=2) for r in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.tick()
    first, second = sorted(reqs, key=lambda r: r.first_chunk_t or 1e30)
    assert first.first_chunk_t is not None and second.first_chunk_t is None
    assert second.admit_t is not None
    eng.run_until_drained()
    assert second.first_chunk_t > first.first_chunk_t >= second.admit_t


def dataclasses_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


class FakeEvent:
    """A device event whose device time the test sets: ``record`` reads
    the shared device clock, a graph's events are set directly."""

    def __init__(self, dev):
        self.dev = dev
        self.t = None

    def record(self, stream=None):
        self.t = self.dev[0]

    def elapsed_time(self, later):
        return (later.t - self.t) * 1e3


def test_settle_splits_gaps_over_host_spans_exactly():
    """Two ticks on an injected host clock and device: the launch's
    latency split between the launch span and its parent, the gap across
    the tick boundary over the read, the decode span, the tick, the
    bookkeeping, the caller (outside) and the next tick's admission; the
    parts sum to the gaps, and busy plus idle tile the device timeline.
    Times are in quarters, so every sum is exact."""
    host, dev = [0.0], [0.0]
    tel = telemetry.Telemetry(clock=lambda: host[0],
                              new_event=lambda: FakeEvent(dev))

    def at(t):
        host[0] = dev[0] = t

    # Tick 1.
    at(0.0)
    t0 = tel.tick_start()
    at(1.0)
    with tel.span("decode", 1):
        at(2.0)
        with tel.span("decode.load", 1, device=True):
            at(3.0)
        with tel.span("decode.launch", 1):
            a, b = tel.device_marks("decode.replay", 1)
            a.t, b.t = 5.0, 9.0          # the graph ran from 5 to 9
            at(4.0)
        host[0] = 4.5
        with tel.span("decode.read", 1, device=True) as rd:
            rd._dev[1].t = 9.0           # reached when the replay ended
            host[0] = 9.0                # the read returned
            tel.settle()
            assert tel._evq == [] and tel._dq == []
            # Mapped at the tick's end, not inside the read's span.
            assert len(tel._settled) == 1 and not tel.device_spans
            host[0] = 9.25
        host[0] = 9.5
    host[0] = 10.0
    with tel.span("record", 1):
        host[0] = 10.5
    host[0] = 11.0
    tel.tick_done(1, t0)
    host[0] = 11.5
    st = tel.span_stats()
    # The gap 3 .. 5: the launch, then decode, then the read just opened;
    # and, nothing in flight, the reading charges 9 .. 11, up to the end
    # of the tick: the read 0.25, decode 0.25, the tick 0.5, the
    # bookkeeping 0.5, the tick 0.5. The caller's 11 .. 11.5 before its
    # reading is charged to no span.
    assert st["idle.decode.launch"]["total_s"] == 1.0
    assert st["idle.decode"]["total_s"] == st["idle.decode.read"][
        "total_s"] == 0.5 + 0.25
    assert st["idle.tick"]["total_s"] == 1.0
    assert st["idle.record"]["total_s"] == 0.5
    assert st["decode.replay.device"]["total_s"] == 4.0
    assert st["decode.load.device"]["total_s"] == 1.0
    assert st["decode.read.device"]["total_s"] == 0.0
    # The caller, then tick 2.
    at(12.5)
    t0 = tel.tick_start()
    at(13.0)
    with tel.span("admit", 2):
        at(14.0)
    at(15.0)
    with tel.span("decode", 2):
        with tel.span("decode.load", 2, device=True):
            at(15.5)
        with tel.span("decode.read", 2, device=True):
            tel.settle()
    tel.tick_done(2, t0)
    st = tel.span_stats()
    # The gap 11.5 .. 15: outside 1, tick 2 0.5, its admission 1, tick 2
    # again 1.
    want = {"idle.decode.launch": 1.0, "idle.decode": 0.5 + 0.25,
            "idle.decode.read": 0.5 + 0.25, "idle.tick": 2.5,
            "idle.record": 0.5, "idle.outside": 1.0, "idle.admit": 1.0}
    got = {k: v["total_s"] for k, v in st.items() if k.startswith("idle.")}
    assert got == want
    assert sum(got.values()) == (5.0 - 3.0) + (11.0 - 9.0) + (15.0 - 11.5)
    busy = sum(v["total_s"] for k, v in st.items() if k.endswith(".device"))
    assert busy + sum(got.values()) == 15.5 - 2.0 - 0.5


def test_charge_idle_tiles_each_gap():
    hosts = [(0.0, 10.0, "tick", 1), (1.0, 4.0, "a", 2), (2.0, 3.0, "b", 3),
             (6.0, 7.0, "c", 4)]
    parts = telemetry.charge_idle([(1.5, 2.5), (3.5, 12.0)], hosts)
    assert parts == [("a", 1.5, 2.0), ("b", 2.0, 2.5), ("a", 3.5, 4.0),
                     ("tick", 4.0, 6.0), ("c", 6.0, 7.0),
                     ("tick", 7.0, 10.0), ("outside", 10.0, 12.0)]


def test_drift_report_reads_the_chunks_device_time(model, host_events):
    """The chunk row compares the replay's device time where it was
    measured, and names the span it read."""
    cfg, params = model
    rows = {}
    for timed in (True, False):
        eng = ServingEngine(params, cfg, _scfg(), device="cpu")
        eng.telemetry.timing = timed and eng.telemetry.timing
        eng._chunk.tel = eng._chunk.tel if timed else None
        for rid in range(2):
            eng.submit(Request(rid=rid, prompt=np.arange(
                3, 20, dtype=np.int32), max_new=3))
        eng.run_until_drained()
        rows[timed] = telemetry.drift_report(eng)["prefill_chunk"]
    assert rows[True]["span"] == "prefill_chunk.replay.device"
    assert rows[False]["span"] == "prefill_chunk"
    assert rows[True]["measured_s"] > 0


# ----------------------------------------------------------------------------
# The benchmark's readers of these, on hand-built runs
# ----------------------------------------------------------------------------

def _read(name, run):
    return harness.reader(name, ROOT)(run)


def _run_of(recs=(), t0=10.0, t1=20.0, **kw):
    cell = harness.load_cell("granite-3-8b.rag-open", ROOT)
    return harness.Run(cell=cell, setup_s=1.0, t0=t0, t1=t1,
                       recs={r.rid: r for r in recs}, esize=2, **kw)


def test_reader_device_idle_pct_engine():
    s0 = {"idle.decode.launch": {"n": 3, "total_s": 1.0},
          "idle.outside": {"n": 1, "total_s": 0.5},
          "decode.replay.device": {"n": 3, "total_s": 4.0}}
    s1 = {"idle.decode.launch": {"n": 9, "total_s": 2.5},
          "idle.outside": {"n": 2, "total_s": 1.0},
          "idle.tick": {"n": 4, "total_s": 0.5},
          "decode.replay.device": {"n": 9, "total_s": 9.0}}
    run = _run_of(spans0=s0, spans1=s1)
    assert _read("device_idle_pct.engine", run) == pytest.approx(
        100.0 * (1.5 + 0.5 + 0.5) / 10.0)
    assert _read("device_idle_pct.engine",
                 _run_of(spans1={"decode": {"n": 1, "total_s": 1.0}})) \
        is None


def test_reader_host_syncs_per_tick():
    run = _run_of(counters0={"ticks": 10, "host_syncs": 40},
                  counters1={"ticks": 30, "host_syncs": 157})
    assert _read("host_syncs.per_tick", run) == pytest.approx(117 / 20)
    assert _read("host_syncs.per_tick",
                 _run_of(counters0={"ticks": 1}, counters1={"ticks": 5})) \
        is None


def test_reader_chunk_device_ms_mean():
    name = "prefill_chunk.replay.device"
    run = _run_of(spans0={name: {"n": 4, "total_s": 0.2}},
                  spans1={name: {"n": 14, "total_s": 0.45}})
    assert _read("chunk_device_ms.mean", run) == pytest.approx(25.0)
    assert _read("chunk_device_ms.mean",
                 _run_of(spans1={"prefill_chunk": {"n": 3,
                                                   "total_s": 1.0}})) \
        is None


def test_reader_queue_wait_p95_counts_a_waiting_request_at_its_wait():
    def rec(rid, due, submit_t, admit_t):
        r = harness.Rec(rid=rid, prompt=np.zeros(4, np.int32), due=due,
                        submit_t=due)
        r.req = Request(rid=rid, prompt=r.prompt, max_new=2,
                        submit_t=submit_t, admit_t=admit_t)
        return r

    recs = [rec(i, 10.0 + 0.2 * i, 10.01 + 0.2 * i, 10.11 + 0.2 * i)
            for i in range(19)]
    recs.append(rec(19, 15.0, 15.0, None))        # waiting at the close
    recs.append(rec(20, 9.0, 9.0, 9.5))           # due before the window
    waits = [0.1] * 19 + [5.0]
    assert _read("queue_wait_ms.p95", _run_of(recs)) == pytest.approx(
        np.percentile(waits, 95) * 1e3)
    unstamped = rec(0, 11.0, None, None)
    assert _read("queue_wait_ms.p95", _run_of([unstamped])) is None


def _charge_idle_by_scan(gaps, hosts):
    """``charge_idle``'s reference: each gap cut at every interval end
    inside it, each piece charged to the covering interval opened last."""
    out = []
    for a, b in gaps:
        cover = [h for h in hosts if h[0] < b and h[1] > a]
        cuts = sorted({a, b} | {t for h in cover for t in h[:2]
                                if a < t < b})
        for p, q in zip(cuts, cuts[1:]):
            mid = (p + q) / 2
            inner = max((h for h in cover if h[0] <= mid < h[1]),
                        key=lambda h: h[3], default=None)
            name = inner[2] if inner is not None else "outside"
            if out and out[-1][0] == name and out[-1][2] == p:
                out[-1] = (name, out[-1][1], q)
            else:
                out.append((name, p, q))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_charge_idle_equals_the_scan_on_nested_spans(seed):
    """Random nested host spans (empty ones among them; the tick and the
    last top-level span still open) and random disjoint gaps on a grid of
    quarters: the sweep's parts equal the scan's."""
    rng = np.random.default_rng(seed)
    hosts, seq = [], [0]

    def spans(t0, t1, depth):
        t, made = t0, []
        while t < t1 and rng.random() < 0.85:
            a = t + int(rng.integers(0, 3))
            b = min(t1, a + int(rng.integers(0, 9)))
            if b < a:
                break
            seq[0] += 1
            made.append(len(hosts))
            hosts.append((a / 4, b / 4, f"s{seq[0]}", seq[0]))
            if depth < 3:
                spans(a, b, depth + 1)
            t = b
        return made

    seq[0] += 1
    hosts.append((0.0, float("inf"), "tick", seq[0]))
    top = spans(0, 200, 0)
    if top:
        a, _, name, q = hosts[top[-1]]
        hosts[top[-1]] = (a, float("inf"), name, q)
    pts = sorted(set(rng.integers(-10, 240, size=16).tolist()))
    gaps = [(pts[i] / 4, pts[i + 1] / 4) for i in range(0, len(pts) - 1, 2)]
    assert telemetry.charge_idle(gaps, hosts) == \
        _charge_idle_by_scan(gaps, hosts)
