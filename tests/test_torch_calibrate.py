"""The port's calibration pass (``core/calibrate.py``, the
``calibrated:`` namespace of its tuning cache) and its drift report, the
counterparts of ``tests/test_calibrate.py`` and the drift tests of
``tests/test_telemetry.py``.

On the CPU (``device="cpu"``) every probe measures its constant finite and
positive through the kernels' plain versions; the page-lookup probe reports
its regression. ``resolve_constants`` prefers calibrated entries, the
engine provably prices its chunk from them, and ``REPRO_DEFAULT_CONSTANTS``
reproduces the default decision. ``drift_report`` carries the constants'
provenance and persists its measurements. The launcher runs here with
``--device cpu --fast --no-persist``. Every test that writes a cache uses
its own tmp file.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import autotune, calibrate
from repro_torch.launch import calibrate as calibrate_launch
from repro_torch.models import transformer as T
from repro_torch.serve import telemetry, traffic
from repro_torch.serve.engine import ServeConfig, ServingEngine, SLOClass

SYNTH = {"dispatch_s": 3e-6, "page_lookup_s": 7e-8,
         "hbm_bandwidth": 2e10, "chunk_dispatch_s": 9e-6,
         "draft_token_s": 4e-6, "prefix_hash_s": 1e-6}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these smoke-size tensors (the suite's
    parallel workers would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    monkeypatch.setattr(autotune, "TUNING_CACHE_PATH", str(path))
    monkeypatch.setattr(autotune, "_tuning_cache", None)
    monkeypatch.delenv(autotune.DEFAULT_CONSTANTS_ENV, raising=False)
    return path


@pytest.fixture(scope="module")
def model():
    cfg = configs.get_smoke("qwen3-4b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return cfg, params


@pytest.fixture(scope="module")
def fast_results():
    """One fast pass on the CPU for the module; persist=False writes no
    cache."""
    return calibrate.run_calibration(fast=True, persist=False, device="cpu")


def _scfg(**kw):
    base = dict(max_len=64, batch=2, eos_id=-1, paged=True, page_size=8,
                chunk_size=8)
    base.update(kw)
    return ServeConfig(**base)


# ----------------------------------------------------------------------------
# Probes
# ----------------------------------------------------------------------------

def test_probes_cover_every_constant_finite_positive(fast_results):
    assert set(fast_results) == set(autotune.CALIBRATED_NAMES)
    for name, r in fast_results.items():
        assert np.isfinite(r.value) and r.value > 0, (name, r)
        assert r.n_trials > 0 and r.unit
        assert np.isfinite(r.spread) and r.spread >= 0


def test_page_lookup_probe_reports_its_regression(fast_results):
    d = fast_results["page_lookup_s"].detail
    assert np.isfinite(d["slope_paged_s"]) and np.isfinite(d["slope_contig_s"])
    assert len(d["tables"]) >= 3
    assert d["heads"] == (32, 8, 80) and d["page_size"] == 16
    # The lookups it regresses on are the model's own count.
    assert d["lookups"] == [autotune.decode_launch(
        [n] * d["batch"], 32, 8, 80, 16)["page_lookups"] for n in d["tables"]]
    assert d["clamped"] == (d["slope_difference_s"]
                            < calibrate.LOOKUP_FLOOR_S)
    assert fast_results["page_lookup_s"].value == max(
        d["slope_difference_s"], calibrate.LOOKUP_FLOOR_S)
    # The CPU runs the plain versions: no kernel launched, none counted.
    assert d["timing"] == "wall"
    assert d["launches"] == {"flash_decode_paged": 0, "flash_decode": 0}


def test_stream_and_chunk_probes_say_what_they_timed(fast_results):
    hbm = fast_results["hbm_bandwidth"].detail
    assert set(hbm["rates_by_dtype"]) == {"float32", "bfloat16"}
    assert fast_results["hbm_bandwidth"].value == max(
        hbm["rates_by_dtype"].values())
    chunk = fast_results["chunk_dispatch_s"].detail
    assert chunk["chunk"] == 8 and chunk["graphed"] is False


def test_probe_result_rejects_nonfinite():
    for name, v in (("dispatch_s", float("nan")), ("dispatch_s", 0.0),
                    ("not_a_constant", 1.0)):
        with pytest.raises(AssertionError):
            calibrate.ProbeResult(name, v, "s", 1, 0.0)


def test_probes_are_the_reference_names_in_order():
    assert tuple(calibrate.PROBES) == autotune.CALIBRATED_NAMES


def test_best_of_reports_min_and_spread():
    times = iter([0.0, 0.0, 0.0, 0.0])
    calls = []
    best, spread, n = calibrate._best_of(lambda: calls.append(next(times)),
                                         2, torch.device("cpu"))
    assert n == 2 and len(calls) == 4            # 2 warm-up, 2 timed
    assert best > 0 and spread >= 0


def test_run_calibration_persists_under_the_device_type(tmp_cache,
                                                        monkeypatch):
    """Injected probe values: every constant lands under
    ``calibrated:cpu:...`` with its evidence, and resolves for the CPU."""
    for name, v in SYNTH.items():
        monkeypatch.setitem(
            calibrate.PROBES, name,
            lambda device, fast, _n=name, _v=v: calibrate.ProbeResult(
                _n, _v, "s", 4, 0.2, {"device": device.type}))
    results = calibrate.run_calibration(fast=True, device="cpu")
    assert {n: r.value for n, r in results.items()} == SYNTH
    raw = json.loads(tmp_cache.read_text())
    keys = sorted(k for k in raw if k.startswith(autotune.CALIBRATED_PREFIX))
    assert keys == sorted(autotune.calibration_key(n, backend="cpu")
                          for n in SYNTH)
    for k in keys:
        e = raw[k]
        assert e["schema_version"] == autotune.CALIBRATION_SCHEMA_VERSION
        assert e["n_trials"] == 4 and e["backend"] == "cpu" and e["fast"]
    const = autotune.resolve_constants(backend="cpu")
    assert const.source == "calibrated" and const.backend == "cpu"
    assert const.page_lookup_s == SYNTH["page_lookup_s"]


def test_run_calibration_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate.run_calibration(fast=True, persist=False)


# ----------------------------------------------------------------------------
# The engine prices its decisions from the calibrated set
# ----------------------------------------------------------------------------

def test_engine_prices_chunk_from_calibrated_set(tmp_cache, model,
                                                 monkeypatch):
    cfg, params = model
    # A measured chunk dispatch far below the assumed one: at the smoke
    # config's tiny attention the chunk model no longer needs the biggest
    # chunk to amortise it.
    autotune.record_calibration("chunk_dispatch_s", 1e-8, backend="cpu",
                                timestamp=42.0)
    scfg = ServeConfig(max_len=512, batch=2, eos_id=-1, paged=True,
                       page_size=8, chunk_size=None)
    eng = ServingEngine(params, cfg, scfg, device="cpu")
    assert eng.constants.source == "calibrated"
    assert eng.constants.chunk_dispatch_s == 1e-8
    expect, _ = autotune.choose_prefill_chunk(
        512, cfg.n_heads, cfg.n_kv_heads, cfg.dhead, 8, in_bytes=4,
        constants=eng.constants)
    assert eng.chunk == expect
    default_chunk, _ = autotune.choose_prefill_chunk(
        512, cfg.n_heads, cfg.n_kv_heads, cfg.dhead, 8, in_bytes=4)
    assert eng.chunk < default_chunk          # the decision moved
    monkeypatch.setenv(autotune.DEFAULT_CONSTANTS_ENV, "1")
    eng2 = ServingEngine(params, cfg, scfg, device="cpu")
    assert eng2.constants == autotune.DEFAULT_CONSTANTS
    assert eng2.chunk == default_chunk


def test_drift_report_carries_constant_provenance(tmp_cache, model):
    cfg, params = model
    autotune.record_calibration("page_lookup_s", 7e-8, backend="cpu",
                                n_trials=3, spread=0.1, timestamp=7.0)
    eng = ServingEngine(params, cfg, _scfg(), device="cpu")
    rep = telemetry.drift_report(eng)
    assert rep["constants"]["source"] == "calibrated"
    assert rep["constants"]["backend"] == "cpu"
    cal = rep["calibration"]
    assert cal["source"] == "calibrated"
    row = cal["constants"]["page_lookup_s"]
    assert row["measured"] == 7e-8
    assert row["drift_ratio"] == pytest.approx(7e-8 / autotune.PAGE_LOOKUP_S)
    assert cal["constants"]["chunk_dispatch_s"]["measured"] is None


def test_drift_report_finite_and_persisted(model, tmp_cache):
    """Counterpart of ``tests/test_telemetry.py::
    test_drift_report_finite_and_persisted``: an overloaded speculative
    run's decode or verify and chunk spans against the models, every
    ratio measured over modelled, the measurements persisted under
    ``serve_measured:``."""
    cfg, params = model
    eng = ServingEngine(params, cfg, _scfg(
        n_pages=17, classes=(SLOClass("default", ttft_slo=8, tpot_slo=4.0),),
        max_queue=4, max_preemptions=3, degrade=True, spec_k=2,
        draft="ngram"), device="cpu")
    arr = traffic.TrafficGenerator(traffic.TrafficConfig(
        rate=1.5, n_requests=16, seed=7, vocab=128,
        classes=(traffic.TrafficClass("default", prompt_lo=4, prompt_hi=20,
                                      out_lo=2, out_hi=6),))).arrivals()
    res = traffic.run_open_loop(eng, arr, max_ticks=2000)
    assert res["unresolved"] == []
    rep = telemetry.drift_report(eng, persist=True)
    assert rep["schema_version"] == telemetry.TRACE_SCHEMA_VERSION
    assert "decode" in rep or "spec_verify" in rep
    assert "prefill_chunk" in rep
    for comp in ("decode", "prefill_chunk", "spec_verify"):
        row = rep.get(comp)
        if row is None:
            continue
        assert row["measured_s"] > 0 and row["modeled_s"] > 0
        assert row["ratio"] == pytest.approx(
            row["measured_s"] / row["modeled_s"])
        assert row["ratio_default"] == row["ratio"]   # nothing calibrated
        assert row["n_spans"] >= 1
    cache = json.loads(tmp_cache.read_text())
    keys = [k for k in cache if k.startswith(autotune.SERVE_MEASURED_PREFIX)]
    assert keys
    for k in keys:
        assert cache[k]["time_s"] > 0 and cache[k]["source"] == \
            "serve.telemetry"


def test_drift_report_refuses_a_contiguous_engine(model):
    cfg, params = model
    eng = ServingEngine(params, cfg, ServeConfig(max_len=32, batch=2),
                        device="cpu")
    with pytest.raises(AssertionError, match="paged"):
        telemetry.drift_report(eng)


# ----------------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------------

def test_launcher_json_on_the_cpu_writes_nothing(tmp_cache, capsys):
    results = calibrate_launch.main(["--device", "cpu", "--fast",
                                     "--no-persist", "--json"])
    assert set(results) == set(autotune.CALIBRATED_NAMES)
    report = json.loads(capsys.readouterr().out)
    assert report["backend"] == "cpu" and report["source"] == "default"
    assert set(report["probe_details"]) == set(autotune.CALIBRATED_NAMES)
    for name, d in report["probe_details"].items():
        assert d["value"] > 0 and d["n_trials"] > 0, name
    assert not tmp_cache.exists()


def test_launcher_table_persists_and_resolves(tmp_cache, capsys):
    calibrate_launch.main(["--device", "cpu", "--fast"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("== calibration [cpu:")
    rows = {line.split()[0] for line in out[2:-1]}
    assert rows == set(autotune.CALIBRATED_NAMES)
    assert out[-1].startswith("constants persisted; engine decisions now "
                              "price from the 'calibrated' set "
                              "(backend=cpu")
    assert autotune.resolve_constants(backend="cpu").source == "calibrated"
