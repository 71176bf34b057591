"""Overload of the PyTorch port's engine against the reference's.

The port's engine and the reference's serve the same open-loop arrivals
(each package's ``TrafficGenerator`` from the same seed, which must agree)
on the same weights (the reference's ``init_params``, carried across
through numpy) on the ``qwen3-4b`` smoke config, with SLO classes, token
buckets, a bounded queue, the preemption cap, the degrade ladder, a
prefill chunk budget and the fault schedule; the reference runs with
``use_flash=True`` (its Pallas kernels in interpret mode), the port its
kernels' plain versions. The event traces (tick, kind and payload),
outcomes, streams, ``shed_by_class``, ``preemption_log``, counters and
``summarize``'s tick-domain numbers must equal the reference's, and a
traced port engine must serve what an untraced one does. The fault
tests hold the port's injector to the reference's contract: a measured,
bounded and recovering response, and streams equal to fault-free
decoding (exact prefixes when force-finished).
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import autotune as jautotune
from repro.models import transformer as JT
from repro.serve import engine as jengine
from repro.serve import faults as jfaults
from repro.serve import spec as jspec
from repro.serve import traffic as jtraffic

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.core import autotune
from repro_torch.serve import engine, faults, spec, traffic
from repro_torch.serve.faults import FaultInjector, Fault, PHANTOM_SLOT

BASE = dict(max_len=64, batch=2, eos_id=-1, paged=True, page_size=8,
            chunk_size=8)
PORT = (engine, traffic, faults)
REF = (jengine, jtraffic, jfaults)


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
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3-4b"), use_flash=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_smoke("qwen3-4b")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, cfg, params


def _classes(mod, classes):
    return None if classes is None else tuple(
        mod.SLOClass(**c) for c in classes)


def _build(model, pkg, **fields):
    """A port (``PORT``) or reference (``REF``) engine; ``classes`` is a
    list of ``SLOClass`` keyword dicts."""
    jcfg, jparams, cfg, params = model
    eng_mod = pkg[0]
    fields = dict(BASE, **fields)
    fields["classes"] = _classes(eng_mod, fields.get("classes"))
    scfg = eng_mod.ServeConfig(**fields)
    if pkg is PORT:
        return engine.ServingEngine(params, cfg, scfg, device="cpu")
    return jengine.ServingEngine(jparams, jcfg, scfg)


def _arrivals(pkg, tclasses=None, **kw):
    tmod = pkg[1]
    base = dict(rate=2.0, n_requests=24, seed=7, vocab=128)
    base.update(kw)
    cls = tclasses or [dict(name="default", prompt_lo=4, prompt_hi=20,
                            out_lo=2, out_hi=6)]
    return tmod.TrafficGenerator(tmod.TrafficConfig(
        classes=tuple(tmod.TrafficClass(**c) for c in cls),
        **base)).arrivals()


def _drive(model, pkg, fields, traffic_kw, schedule=None):
    eng = _build(model, pkg, **fields)
    arr = _arrivals(pkg, **traffic_kw)
    inj = pkg[2].FaultInjector(schedule(pkg[2])) if schedule else None
    res = pkg[1].run_open_loop(eng, arr, max_ticks=2000, injector=inj)
    if inj is not None:
        inj.finish(eng)
    assert res["unresolved"] == []
    return eng, arr, inj


def _trace(eng):
    return [(tick, kind, payload)
            for _, tick, kind, payload in eng.telemetry.events]


def _tick_domain(summary):
    """``summarize``'s numbers that do not read a clock (NaN as None)."""
    wall = ("wall_s", "tick_wall_s_mean", "tick_wall_s_p50",
            "tick_wall_s_p99")

    def clean(d):
        return {k: (clean(v) if isinstance(v, dict) else
                    None if isinstance(v, float) and math.isnan(v) else v)
                for k, v in d.items()
                if k not in wall and "_ms_" not in k}

    return clean(summary)


def _decisions(eng, arr, pkg):
    return dict(trace=_trace(eng), outcome=eng.outcome,
                finished=eng.finished, rejected=eng.rejected,
                shed=dict(eng.shed_by_class),
                preemption_log=list(eng.preemption_log),
                counters=dict(eng.telemetry.counters), ticks=eng.ticks,
                first=eng.first_token_tick, submit=eng.submit_tick,
                finish=eng.finish_tick,
                summary=_tick_domain(pkg[1].summarize(eng, arr)))


def _overload_kw(**kw):
    """The reference's overload knobs (``tests/test_telemetry.py``)."""
    return dict(n_pages=17,
                classes=[dict(name="default", ttft_slo=8, tpot_slo=4.0)],
                max_queue=4, max_preemptions=3, degrade=True,
                trace_capacity=65536, **kw)


def _canonical(fmod):
    return fmod.canonical_schedule(t0=4, dwell=8, gap=6)


# The chip's phase 18 at smoke size: a chat class and a metered batch
# tenant under a burst, the canonical fault schedule, speculation.
TWO_CLASSES = dict(
    fields=dict(n_pages=25, batch=3, spec_k=2, draft="ngram", max_queue=6,
                max_preemptions=3, degrade=True, prefill_chunks_per_tick=2,
                trace_capacity=65536,
                classes=[dict(name="chat", priority=2, ttft_slo=16,
                              tpot_slo=2.0),
                         dict(name="batch", priority=0, rate=6.0)]),
    traffic=dict(process="bursty", rate=0.5, burst_factor=8, n_requests=30,
                 seed=0, max_prompt=40, tclasses=[
                     dict(name="chat", weight=0.7, prompt_lo=4,
                          prompt_hi=16, out_lo=2, out_hi=8),
                     dict(name="batch", weight=0.3, prompt_lo=12,
                          prompt_hi=40, out_lo=4, out_hi=8)]),
    schedule=_canonical)

CASES = {
    "greedy": dict(fields=_overload_kw(),
                   traffic=dict(rate=3.0, n_requests=24)),
    "sampled": dict(fields=_overload_kw(temperature=0.8, seed=3),
                    traffic=dict(rate=2.0, n_requests=16)),
    "spec": dict(fields=_overload_kw(spec_k=2, draft="ngram"),
                 traffic=dict(rate=1.5, n_requests=24), schedule=_canonical),
    "contiguous": dict(
        fields=dict(paged=False, max_queue=3, degrade=True,
                    trace_capacity=65536,
                    classes=[dict(name="hi", priority=2, ttft_slo=4),
                             dict(name="lo", rate=4.0)]),
        traffic=dict(rate=4.0, n_requests=24, process="bursty", tclasses=[
            dict(name="hi", prompt_lo=4, prompt_hi=12, out_lo=2, out_hi=4),
            dict(name="lo", prompt_lo=4, prompt_hi=12, out_lo=2,
                 out_hi=4)])),
    "budget": dict(
        fields=dict(batch=4, prefill_chunks_per_tick=1, max_queue=8,
                    trace_capacity=65536),
        traffic=dict(rate=2.0, n_requests=16, tclasses=[
            dict(name="default", prompt_lo=4, prompt_hi=48, out_lo=2,
                 out_hi=6)])),
    "two_classes": TWO_CLASSES,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_open_loop_decisions_equal_the_reference(model, case):
    """Same arrivals, same decisions: the event trace (tick, kind,
    payload), outcomes, streams, shed and preemption accounting, counters
    and ``summarize``'s tick-domain numbers equal the reference's."""
    c = CASES[case]
    ref, rarr, _ = _drive(model, REF, c["fields"], c["traffic"],
                          c.get("schedule"))
    eng, arr, _ = _drive(model, PORT, c["fields"], c["traffic"],
                         c.get("schedule"))
    assert [(a.tick, a.rid, a.rclass, a.max_new) for a in arr] == \
        [(a.tick, a.rid, a.rclass, a.max_new) for a in rarr]
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in zip(arr, rarr))
    got, want = _decisions(eng, arr, PORT), _decisions(ref, rarr, REF)
    assert eng.telemetry.dropped_events == 0
    for key in want:
        assert got[key] == want[key], key
    # The workload reached the overload paths it is here for.
    kinds = {k for _, k, _ in got["trace"]}
    assert "submit" in kinds and "finish" in kinds
    if case in ("greedy", "contiguous", "two_classes"):
        assert "shed" in kinds
    if case in ("spec", "two_classes"):
        assert {"preempt", "admit_hold", "spec_verify"} <= kinds
    if c["fields"].get("degrade"):
        assert "degrade_enter" in kinds
    if case == "budget":
        # One chunk a tick while two prompts or more were mid-prefill:
        # the budget and the aging order decided who ran.
        assert max(_chunks_per_tick(got["trace"]).values()) == 1
        assert _most_mid_prefill(got["trace"]) >= 2


def _chunks_per_tick(trace):
    out = {}
    for tick, kind, _ in trace:
        if kind == "prefill_chunk":
            out[tick] = out.get(tick, 0) + 1
    return out


def _most_mid_prefill(trace):
    """The most slots admitted and not yet through their last chunk at
    the end of any tick, read from the ``admit`` and ``prefill_chunk``
    events."""
    rows, spans = {}, []
    for tick, kind, p in trace:
        if kind == "admit":
            rows[p["slot"]] = (p["rows"], tick)
        elif kind == "prefill_chunk" and \
                p["start"] + p["rows"] == rows[p["slot"]][0]:
            spans.append((rows[p["slot"]][1], tick))
    last = max(t for t, _, _ in trace)
    return max(sum(a <= t < b for a, b in spans) for t in range(last + 1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_serves_what_untraced_serves(model, case):
    """Telemetry off drops the ring and the clocks only: outcomes,
    streams, ticks and every aggregate stay as they were."""
    c = CASES[case]
    on, _, _ = _drive(model, PORT, c["fields"], c["traffic"],
                      c.get("schedule"))
    off, _, _ = _drive(model, PORT, dict(c["fields"], telemetry=False),
                       c["traffic"], c.get("schedule"))
    assert len(off.telemetry.events) == 0 == len(off.telemetry.spans)
    assert (off.outcome, off.finished, off.ticks) == \
        (on.outcome, on.finished, on.ticks)
    assert off.telemetry.counters == on.telemetry.counters
    assert off.preemption_log == on.preemption_log
    assert off.shed_by_class == on.shed_by_class


def test_prefix_cache_under_overload_equals_the_reference(model):
    """Session traffic (shared prompt heads) through the prefix cache with
    the overload knobs, on a pool where the reference's admission does not
    evict its own probed pages (ROADMAP Queue 3): hits, copy-on-write and
    page events in the trace equal the reference's."""
    fields = dict(_overload_kw(prefix_cache=True), n_pages=25, batch=3)
    tr = dict(rate=1.5, n_requests=20, tclasses=[
        dict(name="default", prompt_lo=2, prompt_hi=10, out_lo=2, out_hi=6,
             sessions=2, prefix_len=16)])
    ref, rarr, _ = _drive(model, REF, fields, tr)
    eng, arr, _ = _drive(model, PORT, fields, tr)
    got, want = _decisions(eng, arr, PORT), _decisions(ref, rarr, REF)
    for key in want:
        assert got[key] == want[key], key
    assert got["counters"].get("prefix_hit", 0) >= 1


def test_accept_collapse_collapses_accepts_not_streams(model):
    """ACCEPT_COLLAPSE wraps the drafter so that every draft misses: in
    its window the verify events accept nothing, outside it the scripted
    drafts land, and the stream is greedy decoding's, as in the
    reference (whose trace the port's equals)."""
    jcfg, jparams, cfg, params = model
    prompt = np.arange(3, 11, dtype=np.int32)
    want = engine.greedy_generate(
        params, cfg, torch.from_numpy(prompt.astype(np.int64))[None], 24,
        max_len=64)[0].tolist()
    traces = []
    for pkg, smod in ((PORT, spec), (REF, jspec)):
        eng = _build(model, pkg, spec_k=2, draft=smod.ScriptedDraft(
            len(prompt), want, [1], cfg.vocab))
        eng.submit(pkg[0].Request(rid=0, prompt=prompt, max_new=24))
        inj = pkg[2].FaultInjector([pkg[2].Fault(
            kind=pkg[2].FaultInjector.ACCEPT_COLLAPSE, start=3, stop=7)])
        for _ in range(100):
            inj.step(eng)
            eng.tick()
            if not eng.queue and all(s is None for s in eng.slots):
                break
        inj.finish(eng)
        assert eng.finished[0] == want
        assert inj.injected == inj.cleared == 1
        traces.append(_trace(eng))
    assert traces[0] == traces[1]
    verify = [(t, p["accepted"]) for t, k, p in traces[0]
              if k == "spec_verify"]
    assert all(a == 0 for t, a in verify if 3 <= t - 1 < 7)
    assert any(a > 0 for t, a in verify if t - 1 >= 7)


# ----------------------------------------------------------------------------
# The pressure signal and the degradation latch (pure functions)
# ----------------------------------------------------------------------------

def test_pressure_functions_equal_the_reference():
    assert (autotune.DEGRADE_HIGH, autotune.DEGRADE_LOW) == \
        (jautotune.DEGRADE_HIGH, jautotune.DEGRADE_LOW)
    for occ in (0.0, 0.3, 0.59, 0.6, 0.85, 0.9, 1.0, 2.0):
        for depth in (0, 1, 2, 7, 8, 100):
            for batch in (1, 2, 8):
                p = autotune.serve_pressure(occ, depth, batch)
                assert p == jautotune.serve_pressure(occ, depth, batch)
                for was in (False, True):
                    for hi, lo in ((0.85, 0.6), (0.5, 0.5), (1.0, 0.0)):
                        assert autotune.choose_degradation(p, was, hi, lo) \
                            == jautotune.choose_degradation(p, was, hi, lo)


def test_serve_pressure_saturates_on_either_resource():
    assert autotune.serve_pressure(0.0, 0, 8) == 0.0
    assert autotune.serve_pressure(0.9, 0, 8) == pytest.approx(0.9)
    assert autotune.serve_pressure(0.1, 8, 8) == 1.0     # queue alone
    assert autotune.serve_pressure(2.0, 100, 8) == 1.0   # bounded
    assert autotune.serve_pressure(0.5, 2, 8) == 0.5     # max, not sum


def test_choose_degradation_hysteresis():
    h, lo = autotune.DEGRADE_HIGH, autotune.DEGRADE_LOW
    assert not autotune.choose_degradation(h - 0.01, False)
    assert autotune.choose_degradation(h, False)          # enter at high
    assert autotune.choose_degradation(lo + 0.01, True)   # dead band holds
    assert not autotune.choose_degradation(lo, True)      # leave at low
    with pytest.raises(AssertionError):
        autotune.choose_degradation(0.5, False, high=0.3, low=0.6)


# ----------------------------------------------------------------------------
# Preemption policy and the faults (the port alone, against greedy decoding)
# ----------------------------------------------------------------------------

def _greedy(model, prompt, n):
    _, _, cfg, params = model
    return engine.greedy_generate(
        params, cfg, torch.from_numpy(prompt.astype(np.int64))[None], n,
        max_len=64)[0].tolist()


def _run(eng, inj, max_ticks=400):
    for _ in range(max_ticks):
        inj.step(eng)
        eng.tick()
        if not eng.queue and all(s is None for s in eng.slots):
            break
    inj.finish(eng)


def test_choose_victim_protects_high_class_and_near_done(model):
    cfg = model[2]
    rng = np.random.RandomState(0)
    eng = _build(model, PORT, batch=3, max_preemptions=3, preempt_cooldown=2,
                 classes=[dict(name="hi", priority=2), dict(name="lo")])
    pr = {r: rng.randint(2, cfg.vocab, 8).astype(np.int32) for r in range(3)}
    eng.submit(engine.Request(rid=0, prompt=pr[0], max_new=20, rclass="hi"))
    eng.submit(engine.Request(rid=1, prompt=pr[1], max_new=20, rclass="lo"))
    eng.submit(engine.Request(rid=2, prompt=pr[2], max_new=8, rclass="lo"))
    for _ in range(3):
        eng.tick()
    assert all(s is not None for s in eng.slots)
    # rid 1: the low class, far from done: the cheapest eviction.
    assert eng._choose_victim([0, 1, 2]) == 1
    # Storm guard: a slot just re-admitted is passed over.
    eng.slots[1].readmitted_at = eng.ticks
    assert eng._choose_victim([0, 1, 2]) == 2
    # Cap guard: a capped slot ranks last; the cooling one comes back
    # before the high class is touched.
    eng.slots[2].preempt_count = 3
    assert eng._choose_victim([0, 1, 2]) == 1
    assert eng._choose_victim([2]) == 2


def test_churn_storm_is_bounded_by_max_preemptions(model):
    cfg = model[2]
    rng = np.random.RandomState(1)
    reqs = [engine.Request(rid=r, prompt=rng.randint(2, cfg.vocab, 10)
                           .astype(np.int32), max_new=16) for r in range(4)]
    eng = _build(model, PORT, max_preemptions=2, preempt_cooldown=1)
    for r in reqs:
        eng.submit(r)
    _run(eng, FaultInjector([Fault(kind=FaultInjector.SLOT_CHURN, start=2,
                                   stop=40, victims_per_tick=2)]))
    assert not eng.queue and all(s is None for s in eng.slots)
    for r in reqs:
        assert r.preempt_count <= 2, (r.rid, r.preempt_count)
        assert eng.outcome[r.rid] in (
            "done", "forced:preempt_limit", "rejected:preempt_limit",
            "forced:max_len")
    evictions = {}
    for rid, _, _ in eng.preemption_log:
        evictions[rid] = evictions.get(rid, 0) + 1
    assert evictions and all(n <= 2 for n in evictions.values())
    assert any(o.endswith("preempt_limit") for o in eng.outcome.values())


def test_pool_squeeze_degrades_then_recovers_bit_identical(model):
    """A phantom co-tenant takes every free page for six ticks: the engine
    holds, preempts or preempts itself, never raises, and once the
    squeeze clears finishes what it can, every stream greedy decoding's
    (an exact prefix when force-finished); no page is leaked."""
    cfg = model[2]
    rng = np.random.RandomState(2)
    prompts = {r: rng.randint(2, cfg.vocab, 12).astype(np.int32)
               for r in range(4)}
    refs = {r: _greedy(model, p, 8) for r, p in prompts.items()}
    eng = _build(model, PORT, n_pages=17, max_preemptions=3)
    for r, pr in prompts.items():
        eng.submit(engine.Request(rid=r, prompt=pr, max_new=8))
    inj = FaultInjector([Fault(kind=FaultInjector.POOL_SQUEEZE, start=2,
                               stop=8, min_free=0)])
    _run(eng, inj)
    assert inj.injected == 1 and inj.cleared == 1
    assert eng.admission_rejections + eng.preemptions >= 1
    assert PHANTOM_SLOT not in eng.pool.slot_pages
    assert eng.pool.pages_in_use == 0
    for r in prompts:
        out = eng.outcome[r]
        if out == "done":
            assert eng.finished[r] == refs[r], r
        elif out.startswith("forced"):
            got = eng.finished[r]
            assert got == refs[r][:len(got)], r
        else:
            assert out.startswith("rejected:"), out


def test_degradation_ladder_downshifts_and_recovers(model):
    cfg = model[2]
    rng = np.random.RandomState(4)
    prompts = {r: rng.randint(2, cfg.vocab, 16).astype(np.int32)
               for r in range(6)}

    def run(degrade):
        eng = _build(model, PORT, degrade=degrade)
        for r, pr in prompts.items():
            eng.submit(engine.Request(rid=r, prompt=pr, max_new=6))
        eng.run_until_drained()
        return eng

    hot, ref = run(True), run(False)
    assert hot.downshifts >= 1 and hot.degraded_ticks >= 1
    assert not hot.degraded, "pressure cleared: the latch must release"
    assert hot.last_pressure <= hot.scfg.pressure_low
    for r in prompts:
        assert hot.finished[r] == ref.finished[r], r


def test_canonical_fault_schedule_end_to_end(model):
    """Pool exhaustion, then accept collapse, then a churn storm against
    open-loop traffic with speculation, SLO admission and degradation:
    every request completes or is cleanly rejected, and every surviving
    stream equals the fault-free engine's (a prefix when forced)."""
    fields = dict(n_pages=17, spec_k=2, draft="ngram", max_queue=8,
                  max_preemptions=3, degrade=True,
                  classes=[dict(name="default", ttft_slo=16)])
    tr = dict(rate=1.5, n_requests=18, seed=11, tclasses=[
        dict(name="default", prompt_lo=4, prompt_hi=20, out_lo=2,
             out_hi=8)])
    faulty, arr, inj = _drive(model, PORT, fields, tr, _canonical)
    clean, _, _ = _drive(model, PORT, fields, tr)
    assert inj.injected == 3 and inj.cleared == 3
    assert faulty.pool.pages_in_use == 0
    compared = 0
    for a in arr:
        if clean.outcome.get(a.rid) != "done":
            continue
        out = faulty.outcome[a.rid]
        if out == "done":
            assert faulty.finished[a.rid] == clean.finished[a.rid], a.rid
            compared += 1
        elif out.startswith("forced"):
            got = faulty.finished[a.rid]
            assert got == clean.finished[a.rid][:len(got)], a.rid
            compared += 1
    assert compared >= 5, "schedule killed (almost) every stream"
    s = traffic.summarize(faulty, arr)
    assert s["done"] + s["forced"] + s["rejected"] == len(arr)


def test_cache_torn_is_a_kind_that_raises_when_armed(model, tmp_path,
                                                    monkeypatch):
    """Armed, ``CACHE_TORN`` tears the port's tuning cache mid-JSON (it
    raised ``NotImplementedError`` before the cache was ported): the
    engine keeps serving, the torn file reads as empty and is discarded,
    and the window's end writes the original bytes back."""
    path = tmp_path / "cache.json"
    good = {"k": {"value": 1.0}}
    path.write_text(json.dumps(good))
    original = path.read_bytes()
    monkeypatch.setattr(autotune, "TUNING_CACHE_PATH", str(path))
    monkeypatch.setattr(autotune, "_tuning_cache", None)
    fault = Fault(kind=FaultInjector.CACHE_TORN, start=1, stop=3)
    eng = _build(model, PORT)
    inj = FaultInjector([fault])
    inj.step(eng)                        # tick 0: not armed yet
    eng.tick()
    inj.step(eng)                        # tick 1: torn
    assert inj.injected == 1 and fault.active
    assert path.read_bytes() != original
    assert autotune._load_tuning_cache() == {}
    eng.tick()
    inj.finish(eng)
    assert inj.cleared == 1
    assert path.read_bytes() == original
    assert autotune._load_tuning_cache() == good


def test_overload_knobs_off_change_nothing(model):
    """Every new field at its default: the schedule and the counters of
    a squeezed speculative run equal those of a run that sets the knobs
    to values that never fire."""
    cfg = model[2]
    rng = np.random.RandomState(6)
    prompts = [rng.randint(2, cfg.vocab, n).astype(np.int32)
               for n in (5, 30, 12, 40, 9, 22)]
    runs = []
    for extra in (dict(), dict(max_queue=100, max_preemptions=1000,
                               prefill_chunks_per_tick=100,
                               classes=[dict(name="default")])):
        eng = _build(model, PORT, n_pages=9, spec_k=2, **extra)
        for rid, p in enumerate(prompts):
            eng.submit(engine.Request(rid=rid, prompt=p, max_new=10))
        out = eng.run_until_drained()
        runs.append((out, eng.ticks, eng.preemptions,
                     eng.admission_rejections, eng.chunk_steps,
                     eng.verify_steps, eng.decode_steps,
                     _trace(eng)))
    assert runs[0] == runs[1]
    # The pool was short, and a speculative engine that never degrades
    # never decodes.
    assert runs[0][2] >= 1 and runs[0][6] == 0
