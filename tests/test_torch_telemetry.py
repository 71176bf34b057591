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

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve import telemetry as jtelemetry

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.serve import telemetry, traffic
from repro_torch.serve.engine import (Request, ServeConfig, ServingEngine,
                                      SLOClass)
from repro_torch.serve.faults import FaultInjector, canonical_schedule
from repro_torch.serve.paged import PageAllocator


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
