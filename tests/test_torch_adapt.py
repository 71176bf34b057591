"""Adaptive speculation, ``context_lengths``, the chunk chooser in the
engine, the torn tuning cache and the serve launcher's new flags, against
the reference.

With one scripted ``rechoose_k`` patched into both ``repro.serve.spec``
and ``repro_torch.serve.spec`` (a test-level patch: no file is edited),
the port's engine and the reference's make the same adaptive decisions:
equal event traces (``probe_tick`` among them), ``k_live`` tick by tick,
``spec_probes``, streams, and the same context lengths and accept rates
handed to ``rechoose_k``. The reference runs with ``use_flash=True`` (its
Pallas kernels in interpret mode), the port its kernels' plain versions,
on the reference's weights carried across through numpy, the ``qwen3-4b``
smoke config. The counterparts of the reference's accept-collapse tests
run with the port's real cost model.
"""

import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve import engine as jengine
from repro.serve import spec as jspec

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.core import autotune
from repro_torch.launch import serve as serve_launch
from repro_torch.models import transformer as T
from repro_torch.serve import engine, spec
from repro_torch.serve.faults import Fault, FaultInjector

BASE = dict(max_len=64, batch=2, eos_id=-1, paged=True, page_size=8,
            chunk_size=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these smoke-size tensors: the suite's
    parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def own_cache(tmp_path, monkeypatch):
    """Each test prices with an empty tuning cache of its own (the
    hand-set constants), whatever the checkout's cache holds."""
    monkeypatch.setattr(autotune, "TUNING_CACHE_PATH",
                        str(tmp_path / "cache.json"))
    monkeypatch.setattr(autotune, "_tuning_cache", None)
    monkeypatch.delenv(autotune.DEFAULT_CONSTANTS_ENV, raising=False)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3-4b"), use_flash=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_smoke("qwen3-4b")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, jparams, cfg, params


def _greedy(model, prompt, n):
    _, _, cfg, params = model
    tokens = torch.from_numpy(np.asarray(prompt, np.int64))[None]
    return engine.greedy_generate(params, cfg, tokens, n,
                                  max_len=64)[0].tolist()


def _pair(model, **fields):
    """(reference engine, port engine) at the same ServeConfig fields."""
    jcfg, jparams, cfg, params = model
    fields = dict(BASE, **fields)
    ref = jengine.ServingEngine(jparams, jcfg, jengine.ServeConfig(**fields))
    eng = engine.ServingEngine(params, cfg, engine.ServeConfig(**fields),
                               device="cpu")
    return ref, eng


def _scripted(ks):
    """A ``rechoose_k`` that returns ``ks`` in turn and records what the
    engine handed it: the slots' lengths, the accept rate, the cap."""
    calls = []

    def rechoose_k(cfg, page_size, lengths, accept_rate, k_max,
                   in_bytes=None, constants=None):
        calls.append(([int(n) for n in lengths], float(accept_rate),
                      int(k_max)))
        return ks[(len(calls) - 1) % len(ks)], {}

    return rechoose_k, calls


def _trace(eng):
    return [(tick, kind, payload)
            for _, tick, kind, payload in eng.telemetry.events]


def _drive(eng, prompts, max_new, mod, inj=None, max_ticks=400):
    """Submit, tick until drained; returns k_live after each tick."""
    for rid, p in enumerate(prompts):
        eng.submit(mod.Request(rid=rid, prompt=np.asarray(p, np.int32),
                               max_new=max_new))
    traj = []
    for _ in range(max_ticks):
        if inj is not None:
            inj.step(eng)
        eng.tick()
        traj.append(int(eng.k_live))
        if not eng.queue and all(s is None for s in eng.slots):
            break
    if inj is not None:
        inj.finish(eng)
    return traj


def _prompts(n=3, seed=3):
    """Prompts whose tails repeat, so that the n-gram drafter proposes."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        motif = rng.randint(2, 128, rng.randint(3, 6))
        out.append(np.concatenate([rng.randint(2, 128, 5),
                                   np.tile(motif, 3)]).astype(np.int32))
    return out


# ----------------------------------------------------------------------------
# Parity with the reference under one scripted rechoose_k
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("ks,every,probe", [
    ((0, 2, 0, 1, 2), 2, 2),
    ((1, 0, 0, 2), 1, 3),
    ((0,), 2, None),
])
def test_adaptive_engine_equals_the_reference(model, monkeypatch, ks, every,
                                              probe):
    ref_fn, ref_calls = _scripted(ks)
    port_fn, port_calls = _scripted(ks)
    monkeypatch.setattr(jspec, "rechoose_k", ref_fn)
    monkeypatch.setattr(spec, "rechoose_k", port_fn)
    ref, eng = _pair(model, spec_k=2, draft="ngram", spec_adapt_every=every,
                     spec_probe_every=probe)
    prompts = _prompts()
    want = _drive(ref, prompts, 14, jengine)
    got = _drive(eng, prompts, 14, engine)
    assert got == want                                # k_live a tick
    assert port_calls == ref_calls and port_calls     # lengths, rates, cap
    assert _trace(eng) == _trace(ref)
    assert eng.spec_probes == ref.spec_probes
    assert eng.finished == ref.finished
    for rid, p in enumerate(prompts):
        assert eng.finished[rid] == _greedy(model, p, 14)
    assert eng.telemetry.counters == ref.telemetry.counters
    for name in ("spec_ticks", "spec_accepted", "spec_emitted",
                 "verify_traces", "decode_traces"):
        assert getattr(eng, name) == getattr(ref, name), name
    if probe is not None and 0 in ks:
        assert eng.spec_probes >= 1


@pytest.mark.parametrize("paged", [False, True])
def test_context_lengths_equal_the_reference(model, paged):
    """Counterpart of ``tests/test_serve.py::
    test_engine_tracks_per_slot_context_lengths``, tick by tick against the
    reference's, through admission, decode, finish and a freed slot's
    drift."""
    fields = dict(max_len=32, batch=2, eos_id=-1)
    if paged:
        fields.update(paged=True, page_size=8, chunk_size=8)
    jcfg, jparams, cfg, params = model
    ref = jengine.ServingEngine(jparams, jcfg, jengine.ServeConfig(**fields))
    eng = engine.ServingEngine(params, cfg, engine.ServeConfig(**fields),
                               device="cpu")
    rng = np.random.RandomState(12)
    prompts = [rng.randint(2, cfg.vocab, n).astype(np.int32)
               for n in (4, 9, 6)]
    for e, mod in ((ref, jengine), (eng, engine)):
        for rid, p in enumerate(prompts):
            e.submit(mod.Request(rid=rid, prompt=p, max_new=3 + 2 * rid))
    for _ in range(16):
        ref.tick()
        eng.tick()
        got = eng.context_lengths()
        assert got.dtype == np.int32 and got.shape == (2,)
        np.testing.assert_array_equal(got, np.asarray(ref.context_lengths()))
    if not paged:
        # The reference's own expectation, on the port.
        eng2 = engine.ServingEngine(params, cfg, engine.ServeConfig(
            max_len=32, batch=2, eos_id=-1), device="cpu")
        eng2.submit(engine.Request(rid=0, prompt=prompts[0], max_new=5))
        eng2.submit(engine.Request(rid=1, prompt=prompts[1], max_new=5))
        eng2.tick()
        np.testing.assert_array_equal(eng2.context_lengths(), [5, 10])
        eng2.tick()
        np.testing.assert_array_equal(eng2.context_lengths(), [6, 11])


# ----------------------------------------------------------------------------
# The chunk chooser in the engine
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("max_len,page", [(64, 8), (256, 16)])
def test_chunk_size_none_equals_the_explicit_chunk(model, max_len, page):
    _, _, cfg, params = model
    fields = dict(max_len=max_len, batch=2, eos_id=-1, paged=True,
                  page_size=page)
    auto = engine.ServingEngine(params, cfg, engine.ServeConfig(
        chunk_size=None, **fields), device="cpu")
    want, _ = autotune.choose_prefill_chunk(
        max_len, cfg.n_heads, cfg.n_kv_heads, cfg.dhead, page, in_bytes=4)
    assert auto.chunk == want and auto.constants.source == "default"
    fixed = engine.ServingEngine(params, cfg, engine.ServeConfig(
        chunk_size=auto.chunk, **fields), device="cpu")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, cfg.vocab, n).astype(np.int32)
               for n in (7, max_len // 2, 3)]
    for e in (auto, fixed):
        for rid, p in enumerate(prompts):
            e.submit(engine.Request(rid=rid, prompt=p, max_new=6))
        e.run_until_drained()
    assert auto.finished == fixed.finished
    assert (auto.ticks, auto.chunk_steps, auto.decode_steps) == \
        (fixed.ticks, fixed.chunk_steps, fixed.decode_steps)


def test_adaptive_fields_are_checked(model):
    _, _, cfg, params = model
    for fields in (dict(spec_adapt_every=2),                 # no spec_k
                   dict(spec_k=2, spec_adapt_every=0),
                   dict(spec_k=2, spec_probe_every=2),       # no window
                   dict(spec_k=2, spec_adapt_every=2, spec_probe_every=0)):
        with pytest.raises(ValueError, match="spec_"):
            engine.ServingEngine(params, cfg, engine.ServeConfig(
                **BASE, **fields), device="cpu")


def test_an_adaptive_engine_builds_the_decode_step_too(model):
    """``k_live`` may reach 0, so the adaptive engine holds the decode
    step beside the verify step (one verify width, spec_k + 1); a fixed
    speculative engine that never degrades holds the verify step only."""
    _, _, cfg, params = model
    fixed = engine.ServingEngine(params, cfg, engine.ServeConfig(
        **BASE, spec_k=2), device="cpu")
    adaptive = engine.ServingEngine(params, cfg, engine.ServeConfig(
        **BASE, spec_k=2, spec_adapt_every=2), device="cpu")
    assert not hasattr(fixed, "_decode")
    assert hasattr(adaptive, "_decode") and hasattr(adaptive, "_verify")
    assert tuple(adaptive._vtok.shape) == (2, 3)


# ----------------------------------------------------------------------------
# Counterparts of the reference's fault tests, with the real cost model
# ----------------------------------------------------------------------------

def test_accept_collapse_probe_ticks_recover_speculation(model):
    """Counterpart of ``tests/test_serve_faults.py::
    test_accept_collapse_probe_ticks_recover_speculation``: an accept
    collapse drives ``k_live`` to 0, and once it clears, trial ticks feed
    the window until the H100 model re-opens speculation; the stream is
    plain greedy decode's throughout, and the verify step is built once."""
    _, _, cfg, params = model
    prompt = list(range(3, 11))
    ref = _greedy(model, prompt, 40)
    draft = spec.ScriptedDraft(len(prompt), ref, [1], cfg.vocab)
    eng = engine.ServingEngine(params, cfg, engine.ServeConfig(
        **dict(BASE, batch=2), spec_k=2, draft=draft, spec_adapt_every=2,
        spec_probe_every=2), device="cpu")
    inj = FaultInjector([Fault(kind=FaultInjector.ACCEPT_COLLAPSE, start=3,
                               stop=11)])
    traj = _drive(eng, [prompt], 40, engine, inj, max_ticks=200)
    assert eng.finished[0] == ref
    assert 0 in traj, "a collapsed accept rate must disable speculation"
    assert eng.spec_probes >= 1
    assert eng.k_live >= 1, \
        "probing must re-open speculation after the collapse clears"
    assert any(traj[traj.index(0):])                  # re-opened after
    assert eng.verify_traces == 1


def test_without_probing_disable_stays_terminal(model):
    """Counterpart of ``tests/test_serve_faults.py::
    test_without_probing_disable_stays_terminal``."""
    _, _, cfg, params = model
    prompt = list(range(5, 13))
    ref = _greedy(model, prompt, 24)
    draft = spec.ScriptedDraft(len(prompt), ref, [1], cfg.vocab)
    eng = engine.ServingEngine(params, cfg, engine.ServeConfig(
        **BASE, spec_k=2, draft=draft, spec_adapt_every=2), device="cpu")
    inj = FaultInjector([Fault(kind=FaultInjector.ACCEPT_COLLAPSE, start=2,
                               stop=8)])
    _drive(eng, [prompt], 24, engine, inj)
    assert eng.finished[0] == ref
    assert eng.k_live == 0 and eng.spec_probes == 0


def test_rechoose_k_disables_at_zero_and_opens_on_the_h100(model):
    """The real model behind the two tests above: on the smoke config a
    rate of 0 prices speculation below plain decode, a perfect rate above;
    the cap holds."""
    _, _, cfg, _ = model
    k0, t0 = spec.rechoose_k(cfg, 8, [20, 30], 0.0, 2)
    k1, t1 = spec.rechoose_k(cfg, 8, [20, 30], 1.0, 2)
    assert k0 == 0 and t0["speedup"] <= 1.0
    assert k1 == 2 and t1["speedup"] > 1.0
    # fp32 weights (the smoke config's compute type), streamed once a tick.
    assert t1["weight_stream_s"] == pytest.approx(
        4.0 * T.active_param_count(cfg) / 3.35e12)


def test_torn_tuning_cache_discards_and_heals(tmp_path, monkeypatch):
    """Counterpart of ``tests/test_serve_faults.py::
    test_torn_tuning_cache_discards_and_heals``, on the port's cache."""
    path = str(tmp_path / "tuning_cache.json")
    good = {autotune.calibration_key("page_lookup_s"): {
        "schema_version": 1, "value": 7e-8}}
    with open(path, "w") as f:
        json.dump(good, f)
    monkeypatch.setattr(autotune, "TUNING_CACHE_PATH", path)
    monkeypatch.setattr(autotune, "_tuning_cache", None)
    assert autotune._load_tuning_cache() == good
    stub = types.SimpleNamespace(ticks=0, pool=None, slots=[],
                                 _prefilling={}, draft=None)
    inj = FaultInjector([Fault(kind=FaultInjector.CACHE_TORN, start=1,
                               stop=3)], cache_path=path)
    stub.ticks = 1
    inj.step(stub)                    # arm: tear the file
    assert autotune._load_tuning_cache() == {}     # discarded, no crash
    assert autotune.resolve_constants() == autotune.DEFAULT_CONSTANTS
    stub.ticks = 3
    inj.step(stub)                    # disarm: heal
    assert inj.injected == 1 and inj.cleared == 1
    assert autotune._load_tuning_cache() == good   # bytes restored
    assert autotune.resolve_constants().page_lookup_s == 7e-8


# ----------------------------------------------------------------------------
# The serve launcher's new flags
# ----------------------------------------------------------------------------

def test_serve_launcher_probes_defaults_and_pool_fraction(capsys,
                                                          monkeypatch):
    # Registered first, so the launcher's own setting is undone after.
    monkeypatch.setenv(autotune.DEFAULT_CONSTANTS_ENV, "0")
    autotune.record_calibration("chunk_dispatch_s", 1e-8, backend="cpu")
    finished = serve_launch.main([
        "--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--paged",
        "--max-len", "64", "--page-size", "8", "--batch", "2",
        "--requests", "4", "--max-new", "8", "--spec-k", "2",
        "--spec-probe-every", "2", "--default-constants", "--pool-frac",
        "0.5"])
    out = capsys.readouterr().out
    assert sorted(finished) == [0, 1, 2, 3]
    assert "constants: hand-set defaults priced choose_*" in out
    # 1 + 2 x 64 / 8 x 0.5 pages: the null page and 8 pages.
    assert "/8 pages high-water" in out
    want, _ = autotune.choose_prefill_chunk(64, 4, 2, 8, 8, in_bytes=4)
    assert f"chunk={want}," in out
    assert "trial ticks" in out and "k_live" in out


def test_serve_launcher_reports_calibrated_constants(capsys):
    autotune.record_calibration("chunk_dispatch_s", 1e-8, backend="cpu",
                                timestamp=1.0)
    serve_launch.main([
        "--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--paged",
        "--max-len", "64", "--page-size", "8", "--batch", "2",
        "--requests", "2", "--max-new", "4", "--rate", "1.0",
        "--spec-k", "2", "--spec-probe-every", "2"])
    out = capsys.readouterr().out
    assert "constants: calibrated [cpu:" in out
    assert "spec probes" in out


def test_serve_launcher_refuses_probing_without_spec():
    with pytest.raises(SystemExit, match="--spec-probe-every"):
        serve_launch.main(["--arch", "qwen3-4b", "--smoke", "--device",
                           "cpu", "--paged", "--spec-probe-every", "2"])
