"""The port's serving cost models and tuning cache against the reference's.

The device-independent parts must equal the reference's exactly: the
causal grid's visited blocks at equal tiles, the expected tokens of a
speculative tick, ``drift_ratio`` and its sentinels, the reservation a
paged decode model reports, the chunk chooser's candidates, the cache-key
shapes and the model's active parameters. The cache has the reference's
contract (a torn file discarded, a malformed entry a miss, torn or
misversioned constants falling back one by one, the env switch), on the
port's own file. The models priced on ``hwmodel.H100`` keep the
reference's properties (monotone costs, page-aligned chunks, no smaller
chunk under a bigger dispatch cost, no larger k under a bigger draft
cost, k = 0 when speculation loses). The Python copies of the kernels'
tile constants are held to ``csrc/paged_attention.cu``.

Every test that writes a cache uses its own tmp file (``tmp_cache``).
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro import configs as jconfigs
from repro.core import autotune as jautotune
from repro.models import transformer as JT

from repro_torch import configs
from repro_torch.core import autotune, hwmodel
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as prefill_kernel
from repro_torch.kernels import flash_decode as decode_kernel
from repro_torch.models import transformer as T

SYNTH = {"dispatch_s": 3e-6, "page_lookup_s": 7e-8,
         "hbm_bandwidth": 2e12, "chunk_dispatch_s": 9e-6,
         "draft_token_s": 4e-6, "prefix_hash_s": 1e-6}
COSTS = tuple(float(c) for c in np.geomspace(1e-7, 1e-2, 12))
SPEC_DIMS = dict(n_heads=32, n_kv_heads=8, head_dim=128, page_size=256,
                 param_bytes=8e9)
SPEC_LENS = [512, 2048, 8192, 32768]


@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    """The port's cache on a tmp file of this test's own; no defaults
    switch leaking in."""
    path = tmp_path / "cache.json"
    monkeypatch.setattr(autotune, "TUNING_CACHE_PATH", str(path))
    monkeypatch.setattr(autotune, "_tuning_cache", None)
    monkeypatch.delenv(autotune.DEFAULT_CONSTANTS_ENV, raising=False)
    return path


# ----------------------------------------------------------------------------
# Exact parity with the reference (device-independent parts)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(1, 1), (5, 517), (64, 64), (65, 300),
                                    (256, 1280), (300, 2048), (16, 4096)])
@pytest.mark.parametrize("bq,bk", [(64, 64), (16, 16), (8, 16), (128, 256)])
def test_visited_blocks_equal_the_reference_at_equal_tiles(sq, skv, causal,
                                                           bq, bk):
    p = autotune.AttnProblem(sq=sq, skv=skv, n_heads=4, head_dim=80,
                             causal=causal)
    jp = jautotune.AttnProblem(sq=sq, skv=skv, n_heads=4, head_dim=80,
                               causal=causal)
    assert autotune._attn_visited_blocks(p, autotune.AttnBlock(bq, bk)) == \
        jautotune._attn_visited_blocks(jp, jautotune.AttnBlock(bq, bk))


@pytest.mark.parametrize("k", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("a", [0.0, 0.3, 0.5, 0.95, 1.0])
def test_expected_spec_tokens_equal_the_reference(k, a):
    assert autotune.expected_spec_tokens(k, a) == \
        jautotune.expected_spec_tokens(k, a)


@pytest.mark.parametrize("m,d", [(1.0, 2.0), (0.0, 2.0), (1.0, 0.0),
                                 (-1.0, 2.0), (float("nan"), 2.0),
                                 (float("inf"), 2.0), (1.0, float("inf")),
                                 (3e-3, 1e-5)])
def test_drift_ratio_and_its_sentinels_equal_the_reference(m, d):
    assert autotune.drift_ratio(m, d) == jautotune.drift_ratio(m, d)


def test_drift_ratio_sentinel():
    """Counterpart of ``tests/test_telemetry.py::
    test_drift_ratio_sentinel``."""
    assert autotune.drift_ratio(1.0, 2.0) == 0.5
    assert autotune.drift_ratio(0.0, 2.0) == 0.0
    assert autotune.drift_ratio(1.0, 0.0) == 0.0
    assert autotune.drift_ratio(float("nan"), 2.0) == 0.0
    assert autotune.drift_ratio(float("inf"), 2.0) == 0.0


@pytest.mark.parametrize("lengths,max_len,page", [
    ([1, 17, 64], 64, 8), ([100, 2048, 513, 0], 2048, 16),
    ([5] * 8, 256, 16), ([4000, 1], 4096, 256)])
def test_paged_decode_reservation_equals_the_reference(lengths, max_len,
                                                       page):
    ours = autotune.paged_decode_model(max_len, lengths, 32, 8, 128, page)
    theirs = jautotune.paged_decode_model(max_len, lengths, 32, 8, 128, page)
    for key in ("page_size", "slots", "rows_resident",
                "rows_reserved_contig", "reservation_ratio",
                "hbm_paged_bytes_per_layer", "hbm_contig_bytes_per_layer"):
        assert ours[key] == theirs[key], key
    assert ours["paged_s"] >= ours["contig_s"] > 0


@pytest.mark.parametrize("max_len,page", [(64, 8), (2048, 16), (4096, 256),
                                          (96, 16), (32768, 256)])
def test_chunk_candidates_equal_the_reference(max_len, page, monkeypatch):
    """Same candidate set (page-aligned powers of two and max_len): the
    chooser prices the same list, and picks one of them."""
    seen = {"ours": [], "theirs": []}
    for mod, key in ((autotune, "ours"), (jautotune, "theirs")):
        real = mod.prefill_chunk_model

        def spy(prompt_len, chunk, *a, _real=real, _key=key, **kw):
            seen[_key].append(chunk)
            return _real(prompt_len, chunk, *a, **kw)

        monkeypatch.setattr(mod, "prefill_chunk_model", spy)
    c, terms = autotune.choose_prefill_chunk(max_len, 32, 8, 128, page)
    _, jterms = jautotune.choose_prefill_chunk(max_len, 32, 8, 128, page)
    assert seen["ours"] == seen["theirs"]
    assert terms["candidates"] == jterms["candidates"] == len(seen["ours"])
    assert c in seen["ours"]


def test_calibration_keys_have_the_reference_shape():
    pat = re.compile(r"calibrated:(cuda|cpu):(dev\d+|mesh\(.*\)):(\w+)$")
    for name in autotune.CALIBRATED_NAMES:
        key = autotune.calibration_key(name)
        m = pat.match(key)
        assert m and m.group(3) == name, key
        assert autotune.calibration_key(name, backend="cpu") == \
            jautotune.calibration_key(name, mesh_shape="dev1",
                                      backend="cpu").replace(
                "dev1", autotune._mesh_key(None))
    assert autotune.calibration_key("page_lookup_s", mesh_shape={"model": 4},
                                    backend="cuda") == \
        jautotune.calibration_key("page_lookup_s", mesh_shape={"model": 4},
                                  backend="cuda")
    assert autotune.CALIBRATED_NAMES == jautotune.CALIBRATED_NAMES
    assert autotune.SERVE_MEASURED_PREFIX == jautotune.SERVE_MEASURED_PREFIX
    assert autotune.DEFAULT_CONSTANTS_ENV == jautotune.DEFAULT_CONSTANTS_ENV


def test_default_keys_name_the_device():
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert autotune._backend_key() == want
    assert autotune._mesh_key(None) == \
        f"dev{max(1, torch.cuda.device_count())}"


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-0.5b", "mamba2-370m"])
@pytest.mark.parametrize("full", [False, True])
def test_active_param_count_equals_the_reference(arch, full):
    get = (configs.get_config, jconfigs.get_config) if full else \
        (configs.get_smoke, jconfigs.get_smoke)
    cfg, jcfg = get[0](arch), get[1](arch)
    assert T.active_param_count(cfg) == JT.active_param_count(jcfg)
    if not full:
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        assert T.tree_param_count(params) == T.active_param_count(cfg)


# ----------------------------------------------------------------------------
# The tuning cache: the port's own file, the reference's contract
# ----------------------------------------------------------------------------

def test_default_cache_is_the_ports_own_under_build():
    default = os.path.join(autotune._REPO_ROOT, "build", "tuning_cache.json")
    assert os.environ.get(autotune.TUNING_CACHE_ENV) or \
        autotune.TUNING_CACHE_PATH == default
    assert "attn_tuning_cache" not in autotune.TUNING_CACHE_PATH
    assert os.path.abspath(autotune.TUNING_CACHE_PATH) != \
        os.path.abspath(jautotune.TUNING_CACHE_PATH)


@pytest.mark.parametrize("garbage", [
    '{"calibrated:cpu:dev1', " ", "\x00\x01binary", "null", "[1, 2, 3]",
    '"str"'])
def test_tuning_cache_recovers_from_corrupt_file(tmp_cache, garbage):
    """A torn write (truncated, binary or a non-object root) is discarded
    and the constants fall back; the next write rebuilds the file."""
    tmp_cache.write_text(garbage)
    assert autotune._load_tuning_cache() == {}
    assert not tmp_cache.exists()
    assert autotune.resolve_constants() == autotune.DEFAULT_CONSTANTS
    autotune.record_calibration("page_lookup_s", 7e-8, timestamp=1.0)
    rebuilt = json.loads(tmp_cache.read_text())
    assert isinstance(rebuilt, dict) and len(rebuilt) == 1


def test_tuning_cache_tolerates_malformed_entry(tmp_cache):
    """A structurally broken entry in a file that parses is a miss; a good
    record overwrites it in place."""
    key = autotune.calibration_key("chunk_dispatch_s")
    for bad in ({"value": 1e-5}, "torn", {"schema_version": 1,
                                          "value": "x"}):
        tmp_cache.write_text(json.dumps({key: bad}))
        autotune._tuning_cache = None
        assert autotune.load_calibration("chunk_dispatch_s") is None
        autotune.record_calibration("chunk_dispatch_s", 3e-5)
        assert json.loads(tmp_cache.read_text())[key]["value"] == 3e-5


def test_tuning_cache_roundtrip(tmp_cache):
    autotune.record_serve_measurement("decode:x", {"time_s": 1e-3, "n": 3})
    assert tmp_cache.exists()
    autotune._tuning_cache = None                 # a fresh process
    assert autotune.load_serve_measurement("decode:x") == \
        {"time_s": 1e-3, "n": 3}
    with pytest.raises(AssertionError):
        autotune.record_serve_measurement("decode:y", {"time_s": 0.0})


def test_record_load_resolve_roundtrip(tmp_cache):
    for name, v in SYNTH.items():
        autotune.record_calibration(name, v, n_trials=5, spread=0.1,
                                    timestamp=123.0)
    for name, v in SYNTH.items():
        hit = autotune.load_calibration(name)
        assert hit["value"] == v and hit["n_trials"] == 5
        assert hit["schema_version"] == autotune.CALIBRATION_SCHEMA_VERSION
    autotune._tuning_cache = None
    const = autotune.resolve_constants()
    assert const.source == "calibrated" and const.timestamp == 123.0
    for name, v in SYNTH.items():
        assert getattr(const, name) == v
    assert const.apply_gpu(hwmodel.H100).hbm_bandwidth == 2e12
    assert autotune.DEFAULT_CONSTANTS.apply_gpu(hwmodel.H100) is hwmodel.H100
    rep = autotune.calibration_report()
    assert rep["source"] == "calibrated"
    for name in autotune.CALIBRATED_NAMES:
        row = rep["constants"][name]
        assert row["measured"] == SYNTH[name]
        assert row["drift_ratio"] == pytest.approx(
            SYNTH[name] / autotune.assumed_constants()[name])
    # Another backend's entries are not this one's.
    assert autotune.resolve_constants(backend="other") == \
        autotune.DEFAULT_CONSTANTS


def test_record_rejects_nonfinite_and_unknown(tmp_cache):
    for name, v in (("dispatch_s", float("inf")), ("dispatch_s", -1e-6),
                    ("dispatch_s", float("nan")),
                    ("made_up_constant", 1.0)):
        with pytest.raises(AssertionError):
            autotune.record_calibration(name, v)
    assert not tmp_cache.exists()


def test_torn_or_misversioned_entries_fall_back_per_constant(tmp_cache):
    blob = {
        autotune.calibration_key("page_lookup_s"): {
            "schema_version": autotune.CALIBRATION_SCHEMA_VERSION,
            "value": 7e-8, "n_trials": 3, "timestamp": 1.0},
        autotune.calibration_key("chunk_dispatch_s"): "torn garbage",
        autotune.calibration_key("draft_token_s"): {
            "schema_version": 999, "value": 1e-6},
        autotune.calibration_key("hbm_bandwidth"): {
            "schema_version": autotune.CALIBRATION_SCHEMA_VERSION,
            "value": -4.0},
        autotune.calibration_key("prefix_hash_s"): {
            "schema_version": autotune.CALIBRATION_SCHEMA_VERSION,
            "value": "not a number"},
    }
    tmp_cache.write_text(json.dumps(blob))
    assert autotune.load_calibration("page_lookup_s")["value"] == 7e-8
    for broken in ("chunk_dispatch_s", "draft_token_s", "hbm_bandwidth",
                   "prefix_hash_s", "dispatch_s"):
        assert autotune.load_calibration(broken) is None
    const = autotune.resolve_constants()
    assert const.source == "calibrated" and const.page_lookup_s == 7e-8
    assert const.chunk_dispatch_s == autotune.CHUNK_DISPATCH_S
    assert const.draft_token_s == autotune.NGRAM_DRAFT_S
    assert const.prefix_hash_s == autotune.PREFIX_HASH_S
    assert const.hbm_bandwidth is None and const.dispatch_s is None


def test_env_switch_forces_defaults(tmp_cache, monkeypatch):
    autotune.record_calibration("chunk_dispatch_s", 1e-3, timestamp=1.0)
    assert autotune.resolve_constants().source == "calibrated"
    monkeypatch.setenv(autotune.DEFAULT_CONSTANTS_ENV, "1")
    assert autotune.resolve_constants() == autotune.DEFAULT_CONSTANTS
    monkeypatch.setenv(autotune.DEFAULT_CONSTANTS_ENV, "0")
    assert autotune.resolve_constants().source == "calibrated"


# ----------------------------------------------------------------------------
# The models on the H100
# ----------------------------------------------------------------------------

def _cost(sq, skv, causal=True, heads=8, batch=1, tile=None):
    p = autotune.AttnProblem(sq=sq, skv=skv, n_heads=heads, head_dim=128,
                             batch=batch, causal=causal)
    return autotune.attn_cost(p, tile or autotune.NAIVE_ATTN_BLOCK)


@given(st.integers(min_value=1, max_value=4096))
def test_attn_cost_monotone_in_kv_length(skv):
    for causal in (True, False):
        assert _cost(64, skv + 64, causal)[0] <= \
            _cost(64, skv + 128, causal)[0]


@given(st.integers(min_value=1, max_value=512))
def test_attn_cost_monotone_in_query_length(sq):
    assert _cost(sq, 2048)[0] <= _cost(sq + 64, 2048)[0]


def test_attn_cost_monotone_in_rows():
    """More rows never cost less; once the launch's CTAs fill the card
    (a wave is 4 CTAs on each of the 132 SMs here), they cost more. Below
    that the launch is as long as its longest CTA, whatever the rows."""
    for b, h in ((1, 4), (2, 8), (4, 32), (8, 32), (16, 32)):
        small = _cost(256, 1024, heads=h, batch=b)
        big = _cost(256, 1024, heads=2 * h, batch=b)
        assert small[0] <= big[0]
        if b * h * 4 >= 4 * hwmodel.H100.sms:
            assert small[0] < big[0], (b, h)


def test_causal_skips_work_and_traffic():
    """At a launch of several waves (8 x 8 heads x 16 query blocks): one
    wave's time is its longest CTA's, which sees every key either way."""
    c, terms_c = _cost(1024, 1024, causal=True, batch=8)
    f, terms_f = _cost(1024, 1024, causal=False, batch=8)
    assert terms_c["visited_blocks"] < terms_f["visited_blocks"]
    assert terms_c["traffic_bytes"] < terms_f["traffic_bytes"]
    assert c < f


def test_query_tile_padding_prices_the_verify_shape():
    """The prefill body pads its query tile to 64 rows: at the verify's
    width (5 rows) the tile runs 5/64 of its rows, and its products cost
    the whole tile."""
    _, terms = _cost(5, 1029)
    assert terms["tile_rows_used"] == pytest.approx(5 / 64)
    _, full = _cost(64, 1088)
    assert terms["compute_s"] == pytest.approx(full["compute_s"], rel=0.02)


def test_decode_tiles_and_peaks_follow_the_dtype():
    """A decode's candidates are the dtype's one query block (16 rows on
    the tensor cores, 8 on the CUDA cores) by each split length; its
    products run at that engine's peak times the used share of the block
    and the launch's fill."""
    p = autotune.AttnProblem(sq=4, skv=2048, n_heads=8, head_dim=80,
                             batch=8, causal=False, in_bytes=4,
                             kernel=autotune.DECODE)
    for in_bytes, bq, peak in ((4, 8, hwmodel.H100.peak_fp32_flops),
                               (2, 16, hwmodel.H100.peak_bf16_flops)):
        q = dataclasses.replace(p, in_bytes=in_bytes)
        cands = autotune.candidate_attn_blocks(q)
        assert cands == [autotune.AttnBlock(bq, r)
                         for r in decode_kernel.SPLIT_ROWS_SET]
        _, t = autotune.attn_cost(q, cands[0])
        assert t["tile_rows_used"] == 4 / bq
        assert t["compute_s"] >= t["flops"] / (peak * 4 / bq * t["fill"])
        assert t["compute_s"] == pytest.approx(max(
            t["flops"] / (peak * 4 / bq * t["fill"]),
            hwmodel.H100.sms * t["cta_issued_flops"] / peak))


def test_prefill_reads_kv_once_a_q_head():
    """The prefill grid is over q heads: 4x the q heads of one kv head
    read 4x the K/V bytes."""
    _, one = _cost(64, 4096, heads=8)
    _, four = _cost(64, 4096, heads=32)
    assert four["traffic_bytes"] == 4 * one["traffic_bytes"]


def test_page_lookups_count_pages_a_row_visits():
    launch = autotune.decode_launch([1024] * 8, 32, 8, 80, 16)
    assert launch["page_lookups"] == 8 * 8 * 1024 // 16
    assert autotune.decode_launch([1024] * 8, 32, 8, 80)["page_lookups"] == 0
    m = autotune.paged_decode_model(2048, [1024] * 8, 32, 8, 80, 16)
    rows, n_splits = decode_kernel.splits(2048, 16, m["tile"][1])
    assert m["split_rows"] == rows
    assert m["ctas"] == 8 * 8 * 1 * n_splits         # b x kvh x gb x splits
    assert m["paged_s"] == pytest.approx(
        m["contig_s"] + launch["page_lookups"] * autotune.PAGE_LOOKUP_S)


def test_prefill_chunk_model_terms():
    dims = dict(n_heads=32, n_kv_heads=8, head_dim=128, page_size=256)
    small = autotune.prefill_chunk_model(8192, 256, **dims)
    whole = autotune.prefill_chunk_model(8192, 8192, **dims)
    assert small["n_chunks"] == 32 and whole["n_chunks"] == 1
    assert small["interleave_latency_s"] < whole["interleave_latency_s"]
    assert small["dispatch_s"] > whole["dispatch_s"]
    assert whole["interleave_latency_s"] == pytest.approx(whole["prefill_s"])
    for terms in (small, whole):
        assert terms["prefill_s"] == pytest.approx(
            terms["attn_s"] + terms["lookup_s"] + terms["dispatch_s"])
        assert terms["lookup_s"] > 0
    hit = autotune.prefill_chunk_model(8192, 256, cached_rows=4096, **dims)
    assert hit["n_chunks"] == 16 and hit["probe_s"] > 0
    assert hit["prefill_s"] < small["prefill_s"]


def test_choose_prefill_chunk_is_page_aligned_and_bounded():
    chunk, terms = autotune.choose_prefill_chunk(
        32768, n_heads=32, n_kv_heads=8, head_dim=128, page_size=256)
    assert chunk % 256 == 0 and 256 <= chunk < 32768
    assert terms["score_s"] >= terms["prefill_s"]
    chunk, _ = autotune.choose_prefill_chunk(2048, 32, 8, 80, 16)
    assert chunk % 16 == 0 and 16 <= chunk <= 2048


@given(st.integers(min_value=0, max_value=len(COSTS) - 1),
       st.integers(min_value=0, max_value=len(COSTS) - 1))
def test_chunk_no_smaller_under_bigger_dispatch_cost(i, j):
    if i > j:
        i, j = j, i
    lo = dataclasses.replace(autotune.DEFAULT_CONSTANTS,
                             chunk_dispatch_s=COSTS[i])
    hi = dataclasses.replace(autotune.DEFAULT_CONSTANTS,
                             chunk_dispatch_s=COSTS[j])
    c_lo, _ = autotune.choose_prefill_chunk(4096, 16, 4, 128, 8, constants=lo)
    c_hi, _ = autotune.choose_prefill_chunk(4096, 16, 4, 128, 8, constants=hi)
    assert c_hi >= c_lo, (COSTS[i], COSTS[j], c_lo, c_hi)


@given(st.integers(min_value=0, max_value=len(COSTS) - 1),
       st.integers(min_value=0, max_value=len(COSTS) - 1))
def test_spec_k_no_larger_under_bigger_draft_cost(i, j):
    if i > j:
        i, j = j, i
    lengths = [256, 512, 1024, 2048]
    lo = dataclasses.replace(autotune.DEFAULT_CONSTANTS,
                             draft_token_s=COSTS[i])
    hi = dataclasses.replace(autotune.DEFAULT_CONSTANTS,
                             draft_token_s=COSTS[j])
    k_lo, _ = autotune.choose_spec_k(lengths, 16, 4, 128, 8, 0.7, 4e9,
                                     constants=lo)
    k_hi, _ = autotune.choose_spec_k(lengths, 16, 4, 128, 8, 0.7, 4e9,
                                     constants=hi)
    assert k_hi <= k_lo, (COSTS[i], COSTS[j], k_lo, k_hi)


def test_constants_argument_defaults_to_the_handset_set():
    plain = autotune.prefill_chunk_model(4096, 256, 16, 4, 128, 8)
    pinned = autotune.prefill_chunk_model(
        4096, 256, 16, 4, 128, 8, constants=autotune.DEFAULT_CONSTANTS)
    assert plain == pinned


def test_measured_stream_rate_prices_the_weight_stream():
    slow = dataclasses.replace(autotune.DEFAULT_CONSTANTS,
                               hbm_bandwidth=1e12)
    a = autotune.spec_decode_model(SPEC_LENS, k=4, accept_rate=0.5,
                                   **SPEC_DIMS)
    b = autotune.spec_decode_model(SPEC_LENS, k=4, accept_rate=0.5,
                                   constants=slow, **SPEC_DIMS)
    assert a["weight_stream_s"] == pytest.approx(8e9 / 3.35e12)
    assert b["weight_stream_s"] == pytest.approx(8e9 / 1e12)


def test_expected_spec_tokens_bounds():
    assert autotune.expected_spec_tokens(0, 0.9) == 1.0
    assert autotune.expected_spec_tokens(4, 0.0) == 1.0
    assert autotune.expected_spec_tokens(4, 1.0) == pytest.approx(5.0)
    e2 = autotune.expected_spec_tokens(2, 0.6)
    e4 = autotune.expected_spec_tokens(4, 0.6)
    assert 1.0 < e2 < e4 < 5.0


def test_spec_decode_model_terms():
    out = autotune.spec_decode_model(SPEC_LENS, k=4, accept_rate=0.8,
                                     **SPEC_DIMS)
    assert out["spec_tick_s"] > out["plain_tick_s"]
    assert out["verify_overhead_frac"] > 0 and out["weight_stream_s"] > 0
    assert out["speedup"] == pytest.approx(
        out["tokens_per_s_spec"] / out["tokens_per_s_plain"])
    assert out["speedup"] > 1.0
    zero = autotune.spec_decode_model(SPEC_LENS, k=4, accept_rate=0.0,
                                      **SPEC_DIMS)
    assert zero["speedup"] < 1.0


def test_spec_speedup_monotone_in_accept_rate():
    prev = 0.0
    for a in (0.1, 0.4, 0.7, 0.95):
        out = autotune.spec_decode_model(SPEC_LENS, k=4, accept_rate=a,
                                         **SPEC_DIMS)
        assert out["speedup"] > prev
        prev = out["speedup"]


def test_choose_spec_k_disables_when_speculation_loses():
    k, terms = autotune.choose_spec_k(SPEC_LENS, accept_rate=0.05,
                                      draft_bytes=1e9, **SPEC_DIMS)
    assert k == 0 and terms["speedup"] <= 1.0
    k2, terms2 = autotune.choose_spec_k(SPEC_LENS, accept_rate=0.7,
                                        **SPEC_DIMS)
    assert k2 >= 1 and terms2["speedup"] > 1.0 and terms2["chosen_k"] == k2


def test_choose_spec_k_grows_with_accept_rate():
    klo, _ = autotune.choose_spec_k(SPEC_LENS, accept_rate=0.3, **SPEC_DIMS)
    khi, _ = autotune.choose_spec_k(SPEC_LENS, accept_rate=0.95,
                                    **SPEC_DIMS)
    assert khi >= klo


def test_choose_prefix_cache_follows_the_hit_rate():
    """Off at hit rate 0 (the probe's tax), on once hits save more
    attention than the probes cost, and monotone in the hit rate."""
    dims = dict(n_heads=32, n_kv_heads=8, head_dim=128, page_size=256)
    speedups = []
    for rate in (0.0, 0.5, 0.9):
        on, terms = autotune.choose_prefix_cache(16384, 15360, rate, **dims)
        assert on == (rate > 0), rate
        speedups.append(terms["speedup"])
    assert speedups[0] < 1.0 < speedups[1] < speedups[2]


# ----------------------------------------------------------------------------
# The tiles, as the kernels' source declares them
# ----------------------------------------------------------------------------

def _cu() -> str:
    return next(s for s in _build.sources()
                if s.name == "paged_attention.cu").read_text()


@pytest.mark.parametrize("name,value", [
    ("PrefillBlockQs", prefill_kernel.BLOCK_QS),
    ("kTileK", prefill_kernel.TILE_K),
    ("kWarpRows", decode_kernel.WARP_ROWS),
    ("kDecThreads", decode_kernel.THREADS)])
def test_tile_constants_match_the_cuda_source(name, value):
    """The Python copies against the source: a scalar constant, or the
    set of query blocks the prefill bodies are instantiated at."""
    if isinstance(value, tuple):
        m = re.search(rf"using {name} = std::integer_sequence<int, "
                      rf"([\d, ]+)>;", _cu())
        assert m and tuple(int(x) for x in m.group(1).split(",")) == value
    else:
        m = re.search(rf"constexpr int {name} = (\d+);", _cu())
        assert m and int(m.group(1)) == value, name


def test_decode_query_block_matches_the_cuda_source():
    m = re.search(r"constexpr int G = std::is_same<T, bf16>::value \? "
                  r"(\d+) : (\d+);", _cu())
    assert m, "dispatch_decode's G"
    assert decode_kernel.QUERY_BLOCK == {torch.bfloat16: int(m.group(1)),
                                         torch.float32: int(m.group(2))}


# ----------------------------------------------------------------------------
# The GEMM tile chooser, priced by the CTAs an SM holds
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2048, 2560, 9728), (2048, 9728, 2560),
                                   (1024, 4096, 1024)])
def test_fp32_chooser_ranks_the_tiles_as_the_card_measured(shape):
    """The card ran the fp32 (64, 16, 64) tile faster than (128, 16, 128)
    at these shapes (``PERF.md`` §6: 0.75-0.84x for the larger tile): six
    resident CTAs of 2 warps against one of 8 (129 registers x 256
    threads). The occupancy-priced model now ranks them so at the MLP
    shapes; at 1024 x 4096 x 1024, one partial wave of either tile, it
    prices them equal (the card: 0.70x), and the tie goes to the first."""
    p = autotune.GemmProblem(*shape, in_bytes=4)
    small, _ = autotune.gemm_cost(p, autotune.GemmConfig(64, 16, 64))
    large, _ = autotune.gemm_cost(p, autotune.GemmConfig(128, 16, 128))
    assert small < large if shape[0] == 2048 else \
        small == pytest.approx(large)
    cfg, _ = autotune.choose_gemm_block(p)
    assert cfg == autotune.GemmConfig(64, 16, 64)
