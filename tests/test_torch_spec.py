"""Speculative decoding of the PyTorch port against the reference's.

The port's paged engine with ``spec_k`` > 0 and the reference's serve the
same prompts on the same weights (the reference's ``init_params``, carried
across through numpy) on the ``qwen3-4b`` smoke config; the reference runs
with ``use_flash=True`` (its Pallas kernels in interpret mode), the port
its kernels' plain versions (CPU tensors). Streams must equal the
reference's and greedy decoding's, and the speculative counters and
scheduling decisions the reference's. Within the port, spec output equals
plain output, greedy and sampled, and the spec slot's K/V rows equal the
plain engine's within 1e-6.
"""

import dataclasses

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
from repro_torch.launch import serve as serve_launch
from repro_torch.serve import engine, paged, sampling, spec

BASE = dict(max_len=64, eos_id=-1, paged=True, page_size=8, chunk_size=8)


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


def _greedy(model, prompt, n):
    _, _, cfg, params = model
    tokens = torch.from_numpy(prompt.astype(np.int64))[None]
    return engine.greedy_generate(params, cfg, tokens, n,
                                  max_len=64)[0].tolist()


def _engines(model, **fields):
    """(reference engine, port engine) at the same ServeConfig fields; a
    ``draft`` given as a callable is built once for each package."""
    jcfg, jparams, cfg, params = model
    draft = fields.pop("draft", None)
    jd, d = (draft(jspec), draft(spec)) if callable(draft) else (draft, draft)
    ref = jengine.ServingEngine(jparams, jcfg, jengine.ServeConfig(
        draft=jd, **BASE, **fields))
    eng = engine.ServingEngine(params, cfg, engine.ServeConfig(
        draft=d, **BASE, **fields), device="cpu")
    return ref, eng


def _serve(eng, request_cls, prompts, max_new, waves=1):
    """Submit ``prompts`` in ``waves`` groups, draining after each."""
    got = {}
    per = -(-len(prompts) // waves)
    for w in range(waves):
        for rid in range(w * per, min((w + 1) * per, len(prompts))):
            eng.submit(request_cls(rid=rid, prompt=prompts[rid].copy(),
                                   max_new=max_new))
        got.update(eng.run_until_drained())
    return got


def _counters(eng):
    return dict(ticks=eng.ticks, spec_ticks=eng.spec_ticks,
                spec_accepted=eng.spec_accepted,
                spec_emitted=eng.spec_emitted,
                verify_traces=eng.verify_traces,
                preemptions=eng.preemptions,
                holds=eng.admission_rejections,
                pages_allocated=eng.pool.pages_allocated)


def _assert_matches(ref, eng, want, got):
    assert got == want
    assert _counters(eng) == _counters(ref)
    assert eng.decode_traces == ref.decode_traces == 0
    assert eng.prefill_traces == ref.prefill_traces
    assert eng.pool.pages_in_use == 0


PATTERNS = {"accept-all": [1], "reject-all": [0], "mixed": [1, 1, 0, 1]}


@pytest.fixture(scope="module")
def scripted_runs(model):
    """For each spec_k, one reference engine and one port engine serve a
    prompt under each pattern in turn (the draft swapped between
    requests, so each package compiles its steps once): per pattern, the
    prompt, greedy decoding's stream, and each engine's stream and the
    deltas of its counters over that request."""
    cfg = model[2]
    runs = {}

    def get(spec_k):
        if spec_k in runs:
            return runs[spec_k]
        ref, eng = _engines(model, batch=1, spec_k=spec_k)
        rng = np.random.RandomState(spec_k)
        out = {}
        for rid, (name, pattern) in enumerate(sorted(PATTERNS.items())):
            prompt = rng.randint(2, cfg.vocab, 7).astype(np.int32)
            want = _greedy(model, prompt, 10)
            got = []
            for e, mod, req in ((ref, jspec, jengine.Request),
                                (eng, spec, engine.Request)):
                e.draft = mod.ScriptedDraft(len(prompt), want, pattern,
                                            cfg.vocab)
                before = _counters(e)
                e.submit(req(rid=rid, prompt=prompt.copy(), max_new=10))
                stream = e.run_until_drained()[rid]
                after = _counters(e)
                got.append((stream, {k: after[k] - before[k]
                                     for k in after}))
            out[name] = (want, *got)
        runs[spec_k] = out, ref, eng
        return runs[spec_k]

    return get


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("spec_k", [1, 2, 4])
def test_scripted_drafts_match_reference_and_greedy(scripted_runs, spec_k,
                                                    pattern):
    """Whatever the draft gets right or wrong, the stream is greedy
    decoding's and the reference's, with its accept counts."""
    out, ref, eng = scripted_runs(spec_k)
    want, (r_stream, r_delta), (stream, delta) = out[pattern]
    assert stream == r_stream == want
    assert delta == r_delta
    assert eng.verify_traces == ref.verify_traces == 1
    assert eng.decode_traces == ref.decode_traces == 0
    assert eng.pool.pages_in_use == 0
    if pattern == "reject-all":
        assert delta["spec_accepted"] == 0
        assert delta["spec_emitted"] == delta["spec_ticks"]
    if pattern == "accept-all":
        assert delta["spec_emitted"] == 9         # 10 minus the prefill's


@pytest.mark.parametrize("fields,waves", [
    (dict(batch=4, spec_k=2), 2),                 # churn: two waves of 3
    (dict(batch=2, spec_k=3, n_pages=6), 1),      # squeezed: preempts
], ids=["churn", "squeezed"])
def test_ngram_engine_matches_reference(model, fields, waves):
    cfg = model[2]
    rng = np.random.RandomState(0)
    lens = (5, 16, 17, 27, 9, 3) if waves > 1 else (7, 15)
    prompts = [rng.randint(2, cfg.vocab, n).astype(np.int32) for n in lens]
    # A repeating tail gives the n-gram drafter something to accept.
    prompts[0] = np.concatenate([prompts[0], prompts[0]])
    ref, eng = _engines(model, draft="ngram", **fields)
    max_new = 9
    want = _serve(ref, jengine.Request, prompts, max_new, waves)
    got = _serve(eng, engine.Request, prompts, max_new, waves)
    _assert_matches(ref, eng, want, got)
    for rid, p in enumerate(prompts):
        assert got[rid] == _greedy(model, p, max_new), rid
    if "n_pages" in fields:
        assert eng.preemptions >= 1


def test_sampled_spec_matches_plain_and_reference(model):
    """At temperature 0.8 the verify draws (rid, t0 + j) keys
    (``fold_span_keys``): the spec stream is the plain sampled engine's
    and the reference spec engine's."""
    cfg = model[2]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, cfg.vocab, n).astype(np.int32) for n in (7, 12)]
    sampled = dict(batch=2, temperature=0.8, seed=11)
    ref, eng = _engines(model, spec_k=3, draft="ngram", **sampled)
    want = _serve(ref, jengine.Request, prompts, 10)
    got = _serve(eng, engine.Request, prompts, 10)
    _assert_matches(ref, eng, want, got)
    _, plain = _engines(model, **sampled)
    assert _serve(plain, engine.Request, prompts, 10) == got
    _, greedy = _engines(model, spec_k=3, batch=2)
    assert _serve(greedy, engine.Request, prompts, 10) != got


def test_verify_keys_are_the_plain_decode_keys():
    base = sampling.prng_key(11)
    rids = torch.tensor([0, 3, -1])
    t0s = torch.tensor([0, 5, 2**31 - 3])
    span = spec.fold_span_keys(base, rids, t0s, 3)
    for j in range(3):
        assert torch.equal(span[:, j],
                           spec.fold_row_keys(base, rids, t0s + j))


def test_spec_cache_rows_match_plain_engine(model):
    """Mid-stream, the spec slot's live K/V rows equal the plain engine's
    within 1e-6 and its write position exactly. The verify projects
    b * (k + 1) rows where plain decode projects b, so equal bits are
    not asserted: whether they hold is recorded in the test's output."""
    _, _, cfg, params = model
    rng = np.random.RandomState(1)
    prompt = rng.randint(2, cfg.vocab, 7).astype(np.int32)
    want = _greedy(model, prompt, 24)
    se = engine.ServingEngine(params, cfg, engine.ServeConfig(
        batch=1, spec_k=4, draft=spec.ScriptedDraft(len(prompt), want,
                                                    [1, 1, 0, 1], cfg.vocab),
        **BASE), device="cpu")
    se.submit(engine.Request(rid=0, prompt=prompt.copy(), max_new=24))
    for _ in range(4):
        se.tick()
    n = len(se.slots[0].generated)
    assert n > 4                                  # drafts were accepted
    pe = engine.ServingEngine(params, cfg, engine.ServeConfig(
        batch=1, **BASE), device="cpu")
    pe.submit(engine.Request(rid=0, prompt=prompt.copy(), max_new=24))
    while pe.slots[0] is None or len(pe.slots[0].generated) < n:
        pe.tick()
    assert se.slots[0].generated == pe.slots[0].generated
    assert se.index[0] == pe.index[0] == len(prompt) + n - 1
    live = len(prompt) + n - 1
    bits_equal = True
    for cs, cp in zip(se.caches, pe.caches):
        for name in ("kp", "vp"):
            a = paged.gather_kv(cs[name], cs[name],
                                torch.from_numpy(se.pages))[0][:, :live]
            b = paged.gather_kv(cp[name], cp[name],
                                torch.from_numpy(pe.pages))[0][:, :live]
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
            bits_equal &= torch.equal(a, b)
    print(f"spec and plain K/V rows bit-equal: {bits_equal}")


def test_model_draft_self_matches_greedy(model):
    """``ModelDraft`` of the target over a window that holds the whole
    context proposes the greedy continuation; an engine drafting with
    it ("self") serves greedy decoding's stream."""
    _, _, cfg, params = model
    rng = np.random.RandomState(9)
    prompt = rng.randint(2, cfg.vocab, 9).astype(np.int32)
    want = _greedy(model, prompt, 6)
    d = spec.ModelDraft(params, cfg, window=16)
    assert d.device.type == "cpu"
    np.testing.assert_array_equal(d.propose(prompt, 3), want[:3])
    eng = engine.ServingEngine(params, cfg, engine.ServeConfig(
        batch=1, spec_k=2, draft="self", **BASE), device="cpu")
    assert isinstance(eng.draft, spec.ModelDraft)
    assert eng.draft.params is params
    got = _serve(eng, engine.Request, [prompt], 6)
    assert got[0] == want
    assert eng.spec_accepted <= eng.spec_ticks * 2
    assert eng.spec_emitted >= eng.spec_ticks
    assert eng.pool.pages_in_use == 0


def test_resolve_draft_variants(model):
    _, _, cfg, params = model
    assert isinstance(spec.resolve_draft(None, cfg, params), spec.NgramDraft)
    assert isinstance(spec.resolve_draft("ngram", cfg, params),
                      spec.NgramDraft)
    custom = spec.NgramDraft(n=2)
    assert spec.resolve_draft(custom, cfg, params) is custom
    md = spec.resolve_draft("qwen2-0.5b", cfg, params, device="cpu")
    assert isinstance(md, spec.ModelDraft) and md.cfg.vocab >= cfg.vocab
    with pytest.raises(TypeError):
        spec.resolve_draft(object(), cfg, params)


@pytest.mark.parametrize("history,k,want", [
    ([5, 6, 7, 9, 5, 6, 7], 1, [9]),              # 3-gram hit
    ([1, 2, 3, 4, 9, 9, 2], 1, [3]),              # backoff to 1
    ([1, 2, 3], 2, []),                           # never repeats
    ([9, 8, 4, 4, 4, 4, 4], 4, [4, 4, 4, 4]),     # constant tail: cyclic
    ([1, 7, 0, 7, 0, 7, 0], 4, [7, 0, 7, 0]),     # period-2 tail
])
def test_ngram_draft_matches_reference(history, k, want):
    h = np.asarray(history, np.int32)
    got = spec.NgramDraft(n=3).propose(h, k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jspec.NgramDraft(n=3).propose(h, k))


@pytest.mark.parametrize("drafts,targets,want", [
    ([3, 4], [3, 4, 9], (2, [3, 4, 9])),
    ([3, 5], [3, 4, 9], (1, [3, 4])),
    ([7], [3, 1], (0, [3])),
    ([], [6], (0, [6])),
])
def test_longest_accept(drafts, targets, want):
    assert spec.longest_accept(drafts, targets) == want
    assert jspec.longest_accept(drafts, targets) == want


def test_spec_and_prefix_cache_need_the_paged_engine(model):
    _, _, cfg, params = model
    for fields in (dict(spec_k=2), dict(prefix_cache=True)):
        with pytest.raises(ValueError, match="paged"):
            engine.ServingEngine(params, cfg, engine.ServeConfig(
                max_len=64, batch=2, **fields), device="cpu")


def test_launcher_serves_spec_with_prefix_cache_on_cpu(capsys):
    finished = serve_launch.main([
        "--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--paged",
        "--max-len", "64", "--page-size", "8", "--chunk-size", "8",
        "--max-new", "6", "--requests", "4", "--batch", "2",
        "--spec-k", "2", "--prefix-cache"])
    assert sorted(finished) == [0, 1, 2, 3]
    assert all(len(v) == 6 for v in finished.values())
    out = capsys.readouterr().out
    assert "spec: k=2 draft=ngram" in out and "prefix cache:" in out
    with pytest.raises(SystemExit):
        serve_launch.main(["--arch", "qwen3-4b", "--smoke", "--device",
                           "cpu", "--spec-k", "2"])
