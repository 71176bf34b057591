"""Open-loop traffic of the PyTorch port (``repro_torch/serve/traffic.py``).

The port's generator must offer the reference's arrivals, field by field,
from the same seed (poisson, bursty and session traffic), and its log
format must round-trip and read the reference's files. Then the
reference's traffic contract on the port's engine: the arrival processes'
shapes, the bounded queue's shed accounting, the token bucket, priority
shedding, liveness under continuous load, and the open-loop launcher on
the CPU.
"""

import json
import re

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve import traffic as jtraffic

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.launch import serve as serve_launch
from repro_torch.models import transformer as T
from repro_torch.serve import traffic
from repro_torch.serve.engine import ServeConfig, ServingEngine, SLOClass


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


def _tcfg(mod=traffic, classes=None, **kw):
    base = dict(rate=2.0, n_requests=40, seed=7, vocab=128)
    base.update(kw)
    cls = classes or [dict(name="default", prompt_lo=4, prompt_hi=24,
                           out_lo=2, out_hi=6)]
    return mod.TrafficConfig(
        classes=tuple(mod.TrafficClass(**c) for c in cls), **base)


def _scfg(**kw):
    base = dict(max_len=64, batch=2, eos_id=-1, paged=True, page_size=8,
                chunk_size=8)
    base.update(kw)
    return ServeConfig(**base)


def _fields(a):
    return (a.tick, a.rid, a.rclass, a.max_new, a.session_id,
            a.prompt.dtype, a.prompt.tolist())


# ----------------------------------------------------------------------------
# The generator: the reference's arrivals from the same seed
# ----------------------------------------------------------------------------

TWO = [dict(name="chat", weight=0.7, prompt_lo=4, prompt_hi=512, out_lo=16,
            out_hi=64, ttft_ms=500.0, tpot_ms=50.0),
       dict(name="batch", weight=0.3, prompt_lo=512, prompt_hi=1536,
            out_lo=32, out_hi=64)]
SESSIONS = [dict(name="chat", weight=2.0, prompt_lo=4, prompt_hi=24,
                 out_lo=2, out_hi=6, sessions=3, prefix_len=16),
            dict(name="batch", prompt_lo=8, prompt_hi=16, out_lo=2,
                 out_hi=4)]
ARRIVALS = {
    "poisson": dict(rate=4.0, n_requests=300),
    "bursty": dict(rate=0.5, n_requests=300, process="bursty",
                   burst_factor=8, seed=0, vocab=151936, max_prompt=1536,
                   classes=TWO),
    "session": dict(rate=1.0, n_requests=200, seed=3, max_prompt=30,
                    classes=SESSIONS),
}


@pytest.mark.parametrize("case", sorted(ARRIVALS))
def test_arrivals_equal_the_reference(case):
    kw = ARRIVALS[case]
    got = traffic.TrafficGenerator(_tcfg(traffic, **kw)).arrivals(rid0=5)
    want = jtraffic.TrafficGenerator(_tcfg(jtraffic, **kw)).arrivals(rid0=5)
    assert len(got) == len(want) == kw["n_requests"]
    assert [_fields(a) for a in got] == [_fields(a) for a in want]


def test_generator_is_deterministic_per_seed():
    a = traffic.TrafficGenerator(_tcfg()).arrivals()
    b = traffic.TrafficGenerator(_tcfg()).arrivals()
    c = traffic.TrafficGenerator(_tcfg(seed=8)).arrivals()
    assert len(a) == len(b) == 40
    assert [_fields(x) for x in a] == [_fields(y) for y in b]
    assert any(x.tick != z.tick or x.prompt.shape != z.prompt.shape
               for x, z in zip(a, c))


def test_session_mode_shares_prefixes_without_perturbing_arrivals():
    base = dict(prompt_lo=4, prompt_hi=12, out_lo=2, out_hi=4)
    off = traffic.TrafficGenerator(_tcfg(classes=[
        dict(name="chat", **base)])).arrivals()
    gen = traffic.TrafficGenerator(_tcfg(classes=[
        dict(name="chat", sessions=3, prefix_len=16, **base)]))
    on = gen.arrivals()
    pool = gen._session_prefixes["chat"]
    assert pool.shape == (3, 16)
    seen = set()
    for a, b in zip(off, on):
        assert (a.tick, a.rid, a.max_new) == (b.tick, b.rid, b.max_new)
        sids = [s for s in range(3) if (pool[s] == b.prompt[:16]).all()]
        assert sids, "arrival head is not a pooled session prefix"
        seen.update(sids)
        np.testing.assert_array_equal(b.prompt[16:], a.prompt)
    assert len(seen) >= 2


def test_session_mode_requires_both_knobs():
    with pytest.raises(AssertionError):
        traffic.TrafficClass("bad", sessions=2)
    with pytest.raises(AssertionError):
        traffic.TrafficClass("bad", prefix_len=8)


def test_poisson_arrivals_match_offered_rate():
    arr = traffic.TrafficGenerator(
        _tcfg(rate=4.0, n_requests=2000)).arrivals()
    ticks = [a.tick for a in arr]
    assert ticks == sorted(ticks)
    span = max(ticks) - min(ticks)   # 2000 gaps at rate 4: ~500 ticks
    assert 0.8 * 500 < span < 1.2 * 500, span


def test_bursty_arrivals_cluster_beyond_poisson():
    arr = traffic.TrafficGenerator(_tcfg(
        rate=1.0, n_requests=1000, process="bursty",
        burst_factor=8.0)).arrivals()
    ticks = np.asarray([a.tick for a in arr])
    window = 20
    counts = [int(((ticks >= t) & (ticks < t + window)).sum())
              for t in range(0, int(ticks.max()), window)]
    assert max(counts) > 40, max(counts)
    assert min(counts[:-1]) < 15, counts


def test_lengths_and_classes_respect_the_mix():
    cls = [dict(name="hot", weight=3.0, prompt_lo=4, prompt_hi=16,
                out_lo=2, out_hi=4),
           dict(name="cold", weight=1.0, prompt_lo=16, prompt_hi=32,
                out_lo=4, out_hi=8)]
    arr = traffic.TrafficGenerator(
        _tcfg(n_requests=400, classes=cls)).arrivals()
    hot = 0
    for a in arr:
        lo, hi = (4, 16) if a.rclass == "hot" else (16, 32)
        assert lo <= len(a.prompt) <= hi
        lo, hi = (2, 4) if a.rclass == "hot" else (4, 8)
        assert lo <= a.max_new <= hi
        hot += a.rclass == "hot"
    assert 250 <= hot <= 350, hot


# ----------------------------------------------------------------------------
# The recorded log format
# ----------------------------------------------------------------------------

def test_recorded_log_round_trips_and_reads_the_reference(tmp_path):
    """write_log -> replay_log -> write_log is a fixed point; the port
    writes the reference's bytes and replays the reference's file to the
    reference's prompts; same-session replays share their heads."""
    cls = [dict(name="chat", prompt_lo=4, prompt_hi=24, out_lo=2, out_hi=6,
                sessions=3, prefix_len=8),
           dict(name="batch", prompt_lo=8, prompt_hi=16, out_lo=2,
                out_hi=4)]
    arrivals = traffic.TrafficGenerator(
        _tcfg(n_requests=30, classes=cls)).arrivals()
    p1, pref = str(tmp_path / "trace.jsonl"), str(tmp_path / "ref.jsonl")
    traffic.write_log(p1, arrivals)
    jtraffic.write_log(pref, jtraffic.TrafficGenerator(
        _tcfg(jtraffic, n_requests=30, classes=cls)).arrivals())
    assert open(p1).read() == open(pref).read()
    replayed = traffic.replay_log(p1, vocab=128, seed=5, prefix_len=8)
    want = jtraffic.replay_log(pref, vocab=128, seed=5, prefix_len=8)
    assert [_fields(b) for b in replayed] == [_fields(b) for b in want]
    for a, b in zip(arrivals, replayed):
        assert (a.tick, a.rclass, len(a.prompt), a.max_new,
                a.session_id) == \
            (b.tick, b.rclass, len(b.prompt), b.max_new, b.session_id)
    by_sid = {}
    for b in replayed:
        if b.session_id is not None:
            by_sid.setdefault(b.session_id, []).append(b)
    multi = [v for v in by_sid.values() if len(v) >= 2]
    assert multi
    for grp in multi:
        for b in grp[1:]:
            np.testing.assert_array_equal(b.prompt[:8], grp[0].prompt[:8])
    p2 = str(tmp_path / "trace2.jsonl")
    traffic.write_log(p2, replayed)
    assert open(p1).read() == open(p2).read()
    again = traffic.replay_log(p2, vocab=128, seed=5, prefix_len=8)
    for b, c in zip(replayed, again):
        np.testing.assert_array_equal(b.prompt, c.prompt)


def test_run_open_loop_record_to_captures_the_offered_trace(model,
                                                            tmp_path):
    cfg, params = model
    eng = ServingEngine(params, cfg, _scfg(), device="cpu")
    arr = traffic.TrafficGenerator(_tcfg(n_requests=8)).arrivals()
    p_rec, p_ref = str(tmp_path / "rec.jsonl"), str(tmp_path / "ref.jsonl")
    res = traffic.run_open_loop(eng, arr, max_ticks=2000, record_to=p_rec)
    assert res["unresolved"] == []
    traffic.write_log(p_ref, arr)
    assert open(p_rec).read() == open(p_ref).read()


# ----------------------------------------------------------------------------
# The engine under offered load
# ----------------------------------------------------------------------------

def test_overload_sheds_cleanly_and_summary_is_sane(model):
    cfg, params = model
    eng = ServingEngine(params, cfg, _scfg(
        n_pages=17, classes=(SLOClass("default", ttft_slo=8, tpot_slo=4.0),),
        max_queue=4, max_preemptions=3), device="cpu")
    arr = traffic.TrafficGenerator(_tcfg(rate=3.0, n_requests=30)).arrivals()
    res = traffic.run_open_loop(eng, arr, max_ticks=2000)
    assert res["unresolved"] == []
    assert eng.shed_by_class.get("default", 0) >= 1
    for rid in res["rejected"]:
        assert eng.outcome[rid].startswith("rejected:")
    s = traffic.summarize(eng, arr)
    assert s["offered"] == 30
    assert s["done"] + s["forced"] + s["rejected"] == 30
    assert s["ttft_p99"] >= s["ttft_p50"] >= 0
    assert 0.0 <= s["shed_rate"] <= 1.0
    assert 0.0 <= s["ttft_slo_attainment"] <= 1.0
    assert s["goodput_tokens_per_tick"] > 0


def test_token_bucket_caps_a_classes_throughput(model):
    cfg, params = model
    rate = 1.0
    eng = ServingEngine(params, cfg, _scfg(
        classes=(SLOClass("metered", rate=rate, burst=8.0),
                 SLOClass("free", priority=1)), max_queue=50), device="cpu")
    tcls = [dict(name="metered", prompt_lo=8, prompt_hi=8, out_lo=4,
                 out_hi=4),
            dict(name="free", prompt_lo=8, prompt_hi=8, out_lo=4, out_hi=4)]
    arr = traffic.TrafficGenerator(
        _tcfg(rate=4.0, n_requests=40, classes=tcls)).arrivals()
    traffic.run_open_loop(eng, arr, max_ticks=2000)
    admitted_tokens = sum(
        12 for a in arr if a.rclass == "metered"
        and not str(eng.outcome.get(a.rid, "")).startswith("rejected"))
    # Debit bucket: spend <= refill + cap + one oversized overshoot.
    assert admitted_tokens <= rate * eng.ticks + 8.0 + 12, \
        (admitted_tokens, eng.ticks)
    done_free = sum(1 for a in arr if a.rclass == "free"
                    and eng.outcome.get(a.rid) == "done")
    assert done_free >= 10


def test_priority_classes_shed_low_first(model):
    cfg, params = model
    eng = ServingEngine(params, cfg, _scfg(
        classes=(SLOClass("hi", priority=2), SLOClass("lo", priority=0)),
        max_queue=3, max_preemptions=3), device="cpu")
    tcls = [dict(name="hi", prompt_lo=4, prompt_hi=12, out_lo=2, out_hi=4),
            dict(name="lo", prompt_lo=4, prompt_hi=12, out_lo=2, out_hi=4)]
    arr = traffic.TrafficGenerator(_tcfg(
        rate=4.0, n_requests=40, classes=tcls, process="bursty")).arrivals()
    res = traffic.run_open_loop(eng, arr, max_ticks=2000)
    assert res["unresolved"] == []
    shed = eng.shed_by_class
    assert shed.get("lo", 0) >= 1
    assert shed.get("hi", 0) <= shed.get("lo", 0)
    s = traffic.summarize(eng, arr)
    hi, lo = s["by_class"]["hi"], s["by_class"]["lo"]
    assert hi["done"] / hi["offered"] >= lo["done"] / lo["offered"]


@given(seed=st.integers(0, 1000), rate=st.sampled_from([1.0, 2.0, 4.0]),
       n_pages=st.sampled_from([17, 25]),
       process=st.sampled_from(["poisson", "bursty"]))
@settings(max_examples=4, deadline=None)
def test_every_offered_request_reaches_a_terminal_outcome(
        seed, rate, n_pages, process):
    """Any seed, rate, pool and arrival shape: every offered request ends
    finished or cleanly rejected within the drain window, a finished one
    emitted its first token, and the drained engine holds nothing."""
    cfg = configs.get_smoke("qwen3-4b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    eng = ServingEngine(params, cfg, _scfg(
        n_pages=n_pages, classes=(SLOClass("default"),), max_queue=6,
        max_preemptions=4), device="cpu")
    arr = traffic.TrafficGenerator(_tcfg(
        rate=rate, n_requests=16, seed=seed, process=process)).arrivals()
    res = traffic.run_open_loop(eng, arr, max_ticks=1500)
    assert res["unresolved"] == [], res["unresolved"]
    for a in arr:
        out = eng.outcome[a.rid]
        if out == "done":
            assert a.rid in eng.first_token_tick
            assert len(eng.finished[a.rid]) >= 1
        else:
            assert out.startswith("forced:") or out.startswith("rejected:")
    assert eng.pool.pages_in_use == 0
    assert all(s is None for s in eng.slots)


# ----------------------------------------------------------------------------
# The open-loop launcher on the CPU
# ----------------------------------------------------------------------------

def test_launcher_serves_open_loop_traffic_with_faults(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    finished = serve_launch.main([
        "--arch", "qwen3-4b", "--paged", "--smoke", "--device", "cpu",
        "--max-len", "64", "--page-size", "8", "--chunk-size", "8",
        "--batch", "2", "--requests", "20", "--rate", "2.0",
        "--process", "bursty", "--max-queue", "6", "--max-preemptions", "3",
        "--degrade", "--faults", "--spec-k", "2",
        "--tenant", "name=paid,priority=2,weight=1,ttft=16",
        "--tenant", "name=free,weight=3,rate=2,burst=16",
        "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "0 unresolved" in out
    armed = re.search(r"(\d+) injected, (\d+) cleared, 0 pages leaked", out)
    assert armed and armed[1] == armed[2] != "0", out
    assert "class paid:" in out and "class free:" in out
    assert finished
    tr = json.loads(trace.read_text())
    assert {e["ph"] for e in tr["traceEvents"]} <= {"X", "i", "C"}


def test_launcher_refuses_traffic_flags_without_rate():
    with pytest.raises(SystemExit):
        serve_launch.main(["--arch", "qwen3-4b", "--smoke", "--device",
                           "cpu", "--faults"])
    with pytest.raises(SystemExit):
        serve_launch.main(["--arch", "qwen3-4b", "--smoke", "--device",
                           "cpu", "--rate", "1", "--tenant", "priority=2"])
