"""Prefix caching of the PyTorch port against the reference's.

The port's paged engine with ``prefix_cache=True`` and the reference's
serve the same prompts (sharing page-aligned prefixes) on the same weights
(the reference's ``init_params``, carried across through numpy) on the
``qwen3-4b`` smoke config; the reference runs with ``use_flash=True`` (its
Pallas kernels in interpret mode), the port its kernels' plain versions.
Streams must equal the reference's and the uncached engine's, greedy,
sampled and speculative; hits, misses, pages mapped, copy-on-write splits,
evictions and page ids must equal the reference's on the same schedule.
The refcounted allocator and the prefix index are held to the
reference's on the same operations.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serve import engine as jengine
from repro.serve import paged as jpaged

from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.serve import engine, paged

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


def _port(model, **fields):
    _, _, cfg, params = model
    return engine.ServingEngine(params, cfg, engine.ServeConfig(
        **dict(BASE, **fields)), device="cpu")


def _ref(model, **fields):
    jcfg, jparams, _, _ = model
    return jengine.ServingEngine(jparams, jcfg, jengine.ServeConfig(
        **dict(BASE, **fields)))


def _greedy(model, prompt, n):
    _, _, cfg, params = model
    return engine.greedy_generate(
        params, cfg, torch.from_numpy(prompt.astype(np.int64))[None], n,
        max_len=64)[0].tolist()


def _shared(vocab, rng, n=3, prefix_len=16):
    """n prompts sharing a page-aligned prefix, distinct short suffixes."""
    shared = rng.randint(2, vocab, prefix_len).astype(np.int32)
    return [np.concatenate([shared, rng.randint(2, vocab, 3 + i)])
            .astype(np.int32) for i in range(n)]


def _serve(eng, request_cls, prompts, max_new, waves=None):
    """Submit the prompts, draining after each rid in ``waves`` (None:
    after every request: sequential sharers)."""
    got = {}
    for rid, p in enumerate(prompts):
        eng.submit(request_cls(rid=rid, prompt=p.copy(), max_new=max_new))
        if waves is None or rid in waves:
            got.update(eng.run_until_drained())
    got.update(eng.run_until_drained())
    return got


def _counters(eng):
    return dict(ticks=eng.ticks, hits=eng.prefix_hits,
                misses=eng.prefix_misses, hit_pages=eng.prefix_hit_pages,
                cows=eng.cow_copies, evictions=eng.prefix_evictions,
                evicted_pages=eng.prefix.evicted_pages,
                preemptions=eng.preemptions,
                holds=eng.admission_rejections,
                pages_allocated=eng.pool.pages_allocated,
                pages_freed=eng.pool.pages_freed,
                index_entries=len(eng.prefix),
                classes=eng.pool.page_classes())


def _run_both(model, prompts, max_new, waves=None, **fields):
    ref = _ref(model, prefix_cache=True, **fields)
    eng = _port(model, prefix_cache=True, **fields)
    want = _serve(ref, jengine.Request, prompts, max_new, waves)
    got = _serve(eng, engine.Request, prompts, max_new, waves)
    assert got == want
    assert _counters(eng) == _counters(ref)
    assert sorted(eng.pool._free) == sorted(ref.pool._free)
    return ref, eng, got


MODES = {"greedy": dict(), "sampled": dict(temperature=0.8, seed=7),
         "spec": dict(spec_k=2, draft="ngram")}


@pytest.fixture(scope="module")
def sharer_runs(model):
    """Three sequential sharers of a 16-token prefix through one slot,
    the reference and the port prefix-cached (``_run_both``), once per
    decoding mode: the prompts, the port engine and its streams."""
    prompts = _shared(model[2].vocab, np.random.RandomState(1))
    runs = {}

    def get(mode):
        if mode not in runs:
            _, eng, got = _run_both(model, prompts, 8, batch=1,
                                    **MODES[mode])
            runs[mode] = prompts, eng, got
        return runs[mode]

    return get


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cached_streams_equal_uncached_and_reference(model, sharer_runs,
                                                     mode):
    prompts, eng, got = sharer_runs(mode)
    assert eng.prefix_hits == 2 and eng.prefix_misses == 1
    assert eng.prefix_hit_pages == 4               # 2 pages each
    uncached = _port(model, batch=1, **MODES[mode])
    assert _serve(uncached, engine.Request, prompts, 8) == got
    if mode == "greedy":
        for rid, p in enumerate(prompts):
            assert got[rid] == _greedy(model, p, 8), rid


def test_after_drain_only_cached_idle_pages_stay_and_clear_frees_them(
        sharer_runs):
    _, eng, _ = sharer_runs("greedy")
    cls = eng.pool.page_classes()
    assert cls["pages_shared"] == cls["pages_exclusive"] == 0
    assert cls["pages_cached_idle"] == eng.pool.pages_in_use > 0
    assert eng.prefix.clear() == cls["pages_cached_idle"]
    assert eng.pool.pages_in_use == 0 and len(eng.prefix) == 0
    assert eng.pool._ref == {} and not eng.pool._index_held
    assert eng.pool.pages_allocated == eng.pool.pages_freed


def test_full_coverage_hit_cows_the_cursor_page(model):
    """A page-aligned prompt cached whole re-prefills its last row: the
    cursor stops inside the last shared page, which splits at admission.
    One copy per prefix stays in the index."""
    cfg = model[2]
    prompt = np.random.RandomState(3).randint(2, cfg.vocab, 16) \
        .astype(np.int32)
    _, eng, got = _run_both(model, [prompt, prompt.copy()], 6, batch=1)
    assert eng.prefix_hits == 1 and eng.prefix_hit_pages == 2
    assert eng.cow_copies == eng.pool.cow_count >= 1
    assert got[0] == got[1] == _greedy(model, prompt, 6)
    assert len(eng.prefix) == 2
    assert eng.pool.page_classes()["pages_cached_idle"] == 2


def test_copy_on_write_copies_the_rows_into_the_new_page(model):
    _, _, cfg, _ = model
    eng = _port(model, batch=1, prefix_cache=True)
    prompt = np.random.RandomState(3).randint(2, cfg.vocab, 16) \
        .astype(np.int32)
    _serve(eng, engine.Request, [prompt], 4)
    eng.submit(engine.Request(rid=1, prompt=prompt.copy(), max_new=4))
    eng.tick()                                     # admitted: split
    old = eng.prefix.probe(prompt, 2)[0][1]
    new = int(eng.pages[0, 1])
    assert new != old and eng.pool.refcount(new) == 1
    row = 16 - 1 - 8                               # the cursor's row
    for c in eng.caches:
        # Rows below the cursor are the cached page's; the cursor's row
        # was rewritten by the chunk (the same token at the same place).
        torch.testing.assert_close(c["kp"][new, :row], c["kp"][old, :row],
                                   atol=0, rtol=0)
        torch.testing.assert_close(c["vp"][new], c["vp"][old], atol=1e-6,
                                   rtol=0)


def test_idle_pages_are_evicted_before_a_preemption(model):
    cfg = model[2]
    rng = np.random.RandomState(4)
    warm = rng.randint(2, cfg.vocab, 24).astype(np.int32)     # 3 pages
    pa = rng.randint(2, cfg.vocab, 15).astype(np.int32)
    pb = rng.randint(2, cfg.vocab, 15).astype(np.int32)
    ref, eng, got = _run_both(model, [warm, pa, pb], 9, waves={0},
                              batch=2, n_pages=9)
    assert eng.prefix_evictions >= 1 and eng.preemptions == 0
    for rid, p in ((1, pa), (2, pb)):
        assert got[rid] == _greedy(model, p, 9), rid


def test_preemption_with_shared_pages_keeps_streams_exact(model):
    cfg = model[2]
    rng = np.random.RandomState(2)
    shared = rng.randint(2, cfg.vocab, 8).astype(np.int32)
    pa = np.concatenate([shared, rng.randint(2, cfg.vocab, 7)]) \
        .astype(np.int32)
    pb = np.concatenate([shared, rng.randint(2, cfg.vocab, 6)]) \
        .astype(np.int32)
    for spec_k in (0, 2):
        _, eng, got = _run_both(model, [pa, pb], 9, waves=set(), batch=2,
                                n_pages=6, spec_k=spec_k)
        assert eng.preemptions >= 1, spec_k
        for rid, p in ((0, pa), (1, pb)):
            assert got[rid] == _greedy(model, p, 9), (spec_k, rid)


def test_slot_mapped_pages_are_never_evicted(model):
    cfg = model[2]
    rng = np.random.RandomState(5)
    shared = rng.randint(2, cfg.vocab, 16).astype(np.int32)
    pa = np.concatenate([shared, rng.randint(2, cfg.vocab, 3)]) \
        .astype(np.int32)
    eng = _port(model, batch=1, prefix_cache=True)
    _serve(eng, engine.Request, [pa], 4)
    eng.submit(engine.Request(rid=1, prompt=pa.copy(), max_new=12))
    eng.tick()                                     # prefix mapped
    shared_before = eng.pool.page_classes()["pages_shared"]
    assert shared_before >= 1
    eng.prefix.evict(64, now=eng.ticks)
    assert eng.pool.page_classes()["pages_shared"] == shared_before
    assert eng.run_until_drained()[1] == _greedy(model, pa, 12)


@pytest.mark.parametrize("seed", range(4))
def test_random_shared_traffic_cached_equals_uncached(model, seed):
    """Random prefix lengths (aligned or not), suffixes and arrival
    waves over two slots, spec on for odd seeds: the cached engine serves
    the uncached engine's streams (the reference's decisions are held
    by the tests above)."""
    cfg = model[2]
    rng = np.random.RandomState(seed)
    shared = rng.randint(2, cfg.vocab, rng.randint(4, 20)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(2, cfg.vocab,
                                                   rng.randint(1, 9))])
               .astype(np.int32) for _ in range(4)]
    eng = _port(model, batch=2, spec_k=seed % 2 * 2, prefix_cache=True)
    got = _serve(eng, engine.Request, prompts, 5, waves={1, 3})
    assert eng.prefix_hits > 0
    uncached = _port(model, batch=2, spec_k=seed % 2 * 2)
    assert _serve(uncached, engine.Request, prompts, 5, waves={1, 3}) == got


def _staggered(eng, request_cls, prompts, max_new):
    """Request 0 alone until its first token, then the rest."""
    reqs = [request_cls(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    eng.submit(reqs[0])
    while not reqs[0].generated:
        eng.tick()
    for r in reqs[1:]:
        eng.submit(r)
    return eng.run_until_drained()


@pytest.mark.parametrize("spec_k,n_pages", [(0, 7), (0, 8), (4, 8), (4, 9)])
def test_admission_never_evicts_the_pages_it_probed(model, spec_k, n_pages):
    """Sharers of a 16-token prefix on a pool too small for them all: an
    admission's eviction makes room without the pages its probe found.
    The reference evicts them when they are the only idle ones left, then
    fails ``PageAllocator.share``'s assertion; where it does not, the
    port's decisions are its decisions (held without speculation)."""
    cfg = model[2]
    rng = np.random.RandomState(7)
    prefix = rng.randint(2, cfg.vocab, 16)
    prompts = [np.concatenate([prefix, rng.randint(2, cfg.vocab, n)])
               .astype(np.int32) for n in rng.randint(2, 11, 6)]
    fields = dict(batch=4, n_pages=n_pages, spec_k=spec_k)
    eng = _port(model, prefix_cache=True, **fields)
    got = _staggered(eng, engine.Request, prompts, 6)
    assert got == _staggered(_port(model, **fields), engine.Request,
                             prompts, 6)
    assert eng.prefix_evictions > 0
    if spec_k:
        return
    ref = _ref(model, prefix_cache=True, **fields)
    if n_pages == 8:                                    # the reference's
        with pytest.raises(AssertionError):             # fault
            _staggered(ref, jengine.Request, prompts, 6)
        return
    assert got == _staggered(ref, jengine.Request, prompts, 6)
    assert _counters(eng) == _counters(ref)


# ----------------------------------------------------------------------------
# The allocator and the index on their own
# ----------------------------------------------------------------------------

def test_refcounted_allocator_matches_reference():
    """Page ids, freed pages, classes and counters equal the reference's
    through allocation, index holds, sharing, a split and refcounted
    frees."""
    steps = [("alloc", 0, 3), ("alloc", 1, 2), ("retain", 1), ("retain", 2),
             ("share", 1, [1, 2]), ("cow", 1, 2), ("free", 0),
             ("release", 1), ("alloc", 2, 2), ("free", 1), ("release", 2),
             ("free", 2)]
    pools = (paged.PageAllocator(8, 4), jpaged.PageAllocator(8, 4))
    for name, *args in steps:
        got = []
        for pool in pools:
            fn = {"alloc": pool.alloc, "retain": pool.retain,
                  "share": pool.share, "cow": pool.cow,
                  "free": pool.free_slot, "release": pool.release}[name]
            got.append(fn(*args))
        assert got[0] == got[1], name
        want = pools[1].occupancy()
        assert pools[0].occupancy() == {k: want[k]
                                        for k in pools[0].occupancy()}, name
    assert pools[0].pages_in_use == 0 and pools[0].cow_count == 1
    lone = paged.PageAllocator(8, 4)
    lone.alloc(0, 1)
    with pytest.raises(AssertionError):
        lone.cow(0, 0)                            # one holder: no split


def test_prefix_index_matches_reference():
    """Probe, publish, LRU eviction (leaves first, slot-held pages kept)
    and clear, on the same operations."""
    rng = np.random.RandomState(0)
    toks = rng.randint(2, 1000, 24)
    other = np.concatenate([toks[:8], rng.randint(2, 1000, 16)])
    out = []
    for mod in (paged, jpaged):
        pool = mod.PageAllocator(16, 8)
        index = mod.PrefixIndex(pool)
        pages = pool.alloc(0, 3)
        parent = mod.ROOT_DIGEST
        for j in range(3):
            parent = index.publish(toks[j * 8:(j + 1) * 8], pages[j], parent,
                                   now=j)
        opages = pool.alloc(1, 3)
        hit, digest, n = index.probe(other, 3, now=5)
        parent = digest
        for j in range(n, 3):
            parent = index.publish(other[j * 8:(j + 1) * 8], opages[j],
                                   parent, now=6)
        pool.free_slot(0)
        trace = [index.probe(toks, 3, now=7)[0], n, len(index),
                 index.evict(2, now=8), len(index), pool.page_classes()]
        pool.free_slot(1)
        trace += [index.evict(1, now=9), index.clear(), pool.pages_in_use,
                  index.evicted_pages, digest]
        out.append(trace)
    assert out[0] == out[1]
    assert out[0][1] == 1                          # one shared page


def test_token_bytes_hash_int64_tokens_as_the_reference_hashes_int32():
    toks = np.arange(5, 13)
    assert paged.token_bytes(toks.astype(np.int64)) == \
        jpaged.token_bytes(toks.astype(np.int32))
    assert paged._page_digest(b"", paged.token_bytes(toks)) == \
        jpaged._page_digest(b"", jpaged.token_bytes(toks))


def test_reservation_matches_reference():
    for lengths in ([0, 1, 17, 64], [5] * 8):
        assert paged.reservation(lengths, 64, 8) == \
            jpaged.reservation(lengths, 64, 8)
