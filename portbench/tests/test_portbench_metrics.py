"""The metrics' arithmetic on hand-made runs: tails over every request
and gap, a request still waiting counted at its age at the close, a rate
over all tokens and the whole window, the counters' ratios, and the
device trace's busy time, families and idle gaps."""

import numpy as np
import pytest

from portbench import cost, harness, peaks, tracer, work
from portbench.tests.smoke import ROOT


def read(name, run):
    return harness.reader(name, ROOT)(run)


def rec(rid, due, times, prompt_len=4):
    r = harness.Rec(rid=rid, prompt=np.zeros(prompt_len, np.int32),
                    due=due, submit_t=due)
    r.times = list(times)
    return r


def make_run(recs, t0=10.0, t1=20.0, **kw):
    cell = harness.load_cell("granite-3-8b.rag-open", ROOT)
    return harness.Run(cell=cell, setup_s=3.0, t0=t0, t1=t1,
                       recs={r.rid: r for r in recs}, esize=2, **kw)


def test_ttft_tail_counts_every_request_due_and_a_waiting_one_at_its_age():
    recs = [rec(i, 10.0 + 0.1 * i, [10.0 + 0.1 * i + 0.05]) for i in range(19)]
    recs.append(rec(19, 12.0, []))                 # no first token by 20.0
    recs.append(rec(20, 9.0, [9.5]))               # due before the window
    recs.append(rec(21, 20.5, [21.0]))             # due after it
    ttfts = [0.05] * 19 + [8.0]
    want = np.percentile(ttfts, 95) * 1e3
    assert read("ttft_p95_ms", make_run(recs)) == pytest.approx(want)


def test_a_request_answered_after_the_close_counts_at_its_age():
    recs = [rec(0, 11.0, [25.0])] + [rec(i, 11.0, [11.01]) for i in range(1, 40)]
    ages = [9.0] + [0.01] * 39
    assert read("ttft_p95_ms", make_run(recs)) == pytest.approx(
        np.percentile(ages, 95) * 1e3)


def test_itl_tail_is_over_every_gap_inside_the_window():
    a = rec(0, 9.0, [9.5, 10.5, 10.6, 10.7, 11.7])   # 9.5 is outside
    b = rec(1, 12.0, [12.1, 12.2, 19.9, 20.4])        # 20.4 is outside
    gaps = [0.1, 0.1, 1.0, 0.1, 7.7]
    assert read("itl_p95_ms", make_run([a, b])) == pytest.approx(
        np.percentile(gaps, 95) * 1e3)


def test_rate_is_every_token_over_the_whole_window():
    a = rec(0, 5.0, [9.0, 10.5, 11.0, 19.0])          # 3 inside
    b = rec(1, 12.0, [12.5, 20.0, 20.1])              # 2 inside (20.0 ends)
    run = make_run([a, b], t0=10.0, t1=20.0)
    assert read("tok_s", run) == pytest.approx(5 / 10.0)
    assert read("setup_s", run) == 3.0


def test_counter_and_span_readers_take_differences_over_the_window():
    run = make_run([], counters0={"decode_steps": 10, "decode_slot_ticks": 100},
                   counters1={"decode_steps": 30, "decode_slot_ticks": 700},
                   spans0={"decode": {"n": 10, "total_s": 1.0}},
                   spans1={"decode": {"n": 30, "total_s": 1.5}},
                   pool_use=[0.2, 0.4])
    assert read("decode_batch.mean", run) == pytest.approx(30.0)
    assert read("decode_step_ms.mean", run) == pytest.approx(25.0)
    assert read("pages_used_pct", run) == pytest.approx(30.0)
    assert read("device_idle_pct", run) is None   # no trace: no number


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


PAGED = ("void (anonymous namespace)::decode_split_kernel<__nv_bfloat16, "
         "128, (anonymous namespace)::PagedLayout>(...)")
CHUNK = ("void (anonymous namespace)::prefill_mma_kernel<128, 64, "
         "(anonymous namespace)::PagedLayout>(...)")


def test_trace_reading_busy_families_and_idle_gaps():
    events = [ev("user_annotation", "portbench.window", 0, 1000),
              ev("user_annotation", "portbench.tick", 0, 600),
              ev("user_annotation", "portbench.observe", 600, 400),
              ev("cuda_runtime", "cudaGraphLaunch", 50, 100),
              ev("kernel", PAGED, 100, 200),
              ev("kernel", "sm90_xmma_gemm_bf16", 250, 150),   # overlaps
              ev("kernel", CHUNK, 500, 50),
              ev("gpu_memcpy", "Memcpy DtoH", 700, 10),
              ev("kernel", "outside", 1200, 100)]
    p = tracer.read_trace(events)
    assert p.window_s == pytest.approx(1e-3)
    assert p.busy_s == pytest.approx((300 + 50 + 10) * 1e-6)
    assert p.family_s["flash_decode_paged"] == pytest.approx(200e-6)
    assert p.family_s["flash_attention_paged"] == pytest.approx(50e-6)
    assert p.family_s["GEMM (cuBLAS)"] == pytest.approx(150e-6)
    idle = dict(p.idle)
    assert idle["tick / cudaGraphLaunch"] == pytest.approx(100e-6)
    assert idle["tick / python"] == pytest.approx(100e-6)
    assert idle["observe / python"] == pytest.approx((150 + 290) * 1e-6)


def test_rooflines_and_mfu_count_useful_work_against_the_peaks():
    run = make_run([rec(7, 10.0, [11.0], prompt_len=600)])
    m = run.cell.model
    run.profile = tracer.Profile(
        window_s=2.0, busy_s=1.0, ops=[], idle=[],
        family_s={"flash_decode_paged": 0.01, "flash_attention_paged": 0.02},
        decode_calls=[(3, 3000)], chunk_calls=[(7, 0, 512), (7, 512, 88)])
    layers = cost.attention_layers(m)
    nb, fl = cost.flash_decode(3, 32, 8, 128, 2, 3000)
    decode = peaks.least_time(nb + 4 * 188, fl) * layers
    assert read("flash_decode_paged_roofline", run) == pytest.approx(
        100 * decode / 0.01)
    flops = (cost.decode_flops(m, 3, 3000) + cost.prefill_flops(m, 0, 512)
             + cost.prefill_flops(m, 512, 88) + cost.head_flops(m))
    assert work.model_flops(run) == pytest.approx(flops)
    assert read("mfu.decode", run) == pytest.approx(100 * flops / 989e12 / 2)
    assert read("mfu.prefill", run) == pytest.approx(100 * flops / 989e12)
    assert 0 < read("flash_attention_paged_roofline", run) < 100


def test_causal_pairs_and_ssd_count_at_a_fixed_chunk():
    assert cost.causal_pairs(4, 4) == 10
    assert cost.causal_pairs(2, 6) == 5 + 6
    assert cost.ssd_scan(1, 300, 128, 64, 16, 2)[1] == cost.ssd_scan(
        1, 300, 128, 64, 16, 2)[1]
    assert cost.ssd_tri(300, cost.SSD_CHUNK) == 128 * 129 + 44 * 45 // 2
