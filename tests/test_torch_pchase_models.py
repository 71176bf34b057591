"""The port's detectors and device model against the reference's.

The geometries of ``tests/test_pchase.py``'s ``make_hier`` cases (random
L1 size, line and sets; Volta's priority policy; two-level TLBs) are built
in both packages and dissected by both packages' detectors, which must give
the same answers, and the right ones. The simulators' ``scan``, ``chase``
and ``make_chain`` and the shared-memory and constant-cache curves are
compared output for output. The port's detectors also take any object
with ``flush()`` and ``scan()``, not only the simulator's class.
"""

import itertools

import numpy as np
import pytest

from repro.core import hwmodel as rhw
from repro.core import pchase as rpchase
from repro.core import simulator as rsim
from repro_torch.core import hwmodel, pchase, simulator

KiB = 1024


def make_hier(sim, l1_size=32 * KiB, l1_line=32, l1_sets=4, policy="lru",
              reserved=0, l2_size=512 * KiB, l2_line=64, l2_ways=16,
              tlb1=(16, 128 * KiB), tlb2=(64, 1024 * KiB),
              caches_enabled=True):
    """``tests/test_pchase.py``'s ``make_hier`` in the package ``sim``."""
    return sim.MemoryHierarchy(
        sim.SetAssocCache(l1_size, l1_line, sets=l1_sets, policy=policy,
                          reserved_ways=reserved),
        sim.SetAssocCache(l2_size, l2_line, ways=l2_ways, policy="lru"),
        sim.TLB(tlb1[0] * tlb1[1], tlb1[1]),
        sim.TLB(tlb2[0] * tlb2[1], tlb2[1]),
        sim.LatencyConfig(),
        caches_enabled=caches_enabled)


def both(**kw):
    return make_hier(simulator, **kw), make_hier(rsim, **kw)


# The reference draws 12 of these 45 geometries; a seeded 12 here.
L1_GEOMETRIES = [g for i, g in enumerate(itertools.product(
    [8, 16, 24, 32, 64], [32, 64, 128], [2, 4, 8]))
    if i in set(np.random.RandomState(2).choice(45, 12, replace=False))]


@pytest.mark.parametrize("size_kib,line,sets", L1_GEOMETRIES)
def test_random_l1_geometry_recovered_by_both(size_kib, line, sets):
    answers = []
    for mod, hier in zip((pchase, rpchase),
                         both(l1_size=size_kib * KiB, l1_line=line,
                              l1_sets=sets, l2_size=4096 * KiB)):
        size = mod.detect_size(hier, lo=2 * KiB, hi=256 * KiB, stride=8)
        got_line = mod.detect_line(hier, size)
        l2_hit = mod.measure_next_level_latency(hier, size)
        ways = mod.detect_ways(hier, size, miss_threshold=l2_hit,
                               max_ways=2048)
        answers.append((size, got_line, l2_hit, ways))
    assert answers[0] == answers[1]
    size, got_line, _, ways = answers[0]
    assert (size, got_line, size // (got_line * ways)) == \
        (size_kib * KiB, line, sets)


@pytest.mark.parametrize("reserved", [4, 16, 56])
def test_prio_policy_recovered_by_both(reserved):
    answers = []
    for mod, hier in zip((pchase, rpchase),
                         both(policy="prio", reserved=reserved)):
        size = mod.detect_size(hier, lo=2 * KiB, hi=256 * KiB, stride=8,
                               resolution=8, threshold=0.0)
        answers.append((size, mod.detect_policy(size, 32 * KiB)))
    assert answers[0] == answers[1]
    assert abs(answers[0][0] - (32 * KiB - reserved * 4 * 32)) < 8


def test_lru_policy_detected_by_both():
    got = [mod.detect_policy(mod.detect_size(h, lo=2 * KiB, hi=256 * KiB,
                                             stride=8), 32 * KiB)
           for mod, h in zip((pchase, rpchase), both())]
    assert got == ["LRU", "LRU"]


TLB_GEOMETRIES = list(itertools.product([8, 16, 32], [128, 256], [64, 128]))


@pytest.mark.parametrize("entries1,page1_kib,entries2", TLB_GEOMETRIES)
def test_random_tlbs_recovered_by_both(entries1, page1_kib, entries2):
    page2 = 8 * page1_kib * KiB
    got = []
    for mod, hier in zip((pchase, rpchase),
                         both(tlb1=(entries1, page1_kib * KiB),
                              tlb2=(entries2, page2), caches_enabled=False)):
        tlbs = mod.dissect_tlbs(
            hier,
            page_candidates_l1=[32 * KiB, 64 * KiB, 128 * KiB, 256 * KiB,
                                512 * KiB],
            page_candidates_l2=[page1_kib * KiB * m for m in (1, 2, 4, 8,
                                                               16)],
            max_pages=300)
        got.append([(t.page_entry, t.coverage) for t in tlbs])
    assert got[0] == got[1] == [(page1_kib * KiB, entries1 * page1_kib * KiB),
                                (page2, entries2 * page2)]


@pytest.mark.parametrize("span", [4 * KiB, 64 * KiB])
def test_latency_classes_equal_on_both(span):
    got = [mod.latency_classes(h, span=span)
           for mod, h in zip((pchase, rpchase),
                             (simulator.build_hierarchy(hwmodel.V100),
                              rsim.build_hierarchy(rhw.V100)))]
    assert got[0].__dict__ == got[1].__dict__
    assert (got[1].l1_hit, got[1].cold) == (28, 1029)


class Opaque:
    """Only the interface the detectors may use: ``flush`` and ``scan``."""

    def __init__(self, hier):
        self._h = hier

    def flush(self):
        self._h.flush()

    def scan(self, addrs):
        return self._h.scan(addrs)


def test_detectors_take_any_flush_and_scan_device():
    plain = simulator.build_hierarchy(hwmodel.V100)
    duck = Opaque(simulator.build_hierarchy(hwmodel.V100))
    args = dict(lo=2 * KiB, hi=512 * KiB, stride=8)
    assert pchase.detect_size(duck, **args) == \
        pchase.detect_size(plain, **args)
    assert pchase.detect_line(duck, 64 * KiB) == \
        pchase.detect_line(plain, 64 * KiB)
    assert pchase.measure_hit_latency(duck, 8) == \
        pchase.measure_hit_latency(plain, 8)


# ----------------------------------------------------------------------------
# The simulator itself
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n_bytes,stride,start",
                         [(4096, 64, 0), (64 * KiB, 8, 512),
                          (1 << 20, 128, 0), (300, 96, 8)])
def test_make_chain_equals_the_reference(n_bytes, stride, start):
    np.testing.assert_array_equal(simulator.make_chain(n_bytes, stride,
                                                       start),
                                  rsim.make_chain(n_bytes, stride, start))


@pytest.mark.parametrize("name", ["V100", "P100", "K80"])
def test_scan_and_chase_equal_the_reference(name):
    port = simulator.build_hierarchy(hwmodel.GPUS[name])
    ref = rsim.build_hierarchy(rhw.GPUS[name])
    rng = np.random.RandomState(9)
    addrs = rng.randint(0, 1 << 26, 3000).astype(np.int64) // 8 * 8
    np.testing.assert_array_equal(port.scan(addrs), ref.scan(addrs))
    np.testing.assert_array_equal(port.scan(np.arange(0, 512, 8)),
                                  ref.scan(np.arange(0, 512, 8)))
    chain = simulator.make_chain(256 * KiB, 32)
    np.testing.assert_array_equal(port.chase(chain, steps=20_000, flush=True),
                                  ref.chase(chain, steps=20_000, flush=True))
    assert (port.l1.hits, port.l2.misses, port.tlb_accesses) == \
        (ref.l1.hits, ref.l2.misses, ref.tlb_accesses)


@pytest.mark.parametrize("name", ["V100", "P100", "P4", "M60", "K80"])
def test_smem_and_constant_curves_equal_the_reference(name):
    spec, rspec = hwmodel.GPUS[name], rhw.GPUS[name]
    for stride in (1, 2, 3, 4, 8, 16, 32, 64):
        assert simulator.smem_conflict_degree(spec, stride) == \
            rsim.smem_conflict_degree(rspec, stride)
        assert simulator.smem_latency(spec, stride) == \
            rsim.smem_latency(rspec, stride)
    for level in ("l1", "l1.5", "l2"):
        for distinct in (1, 2, 4, 8, 16, 32):
            assert simulator.constant_latency(spec, level, distinct) == \
                rsim.constant_latency(rspec, level, distinct)
    assert simulator.volta_reserved_ways(spec) == \
        rsim.volta_reserved_ways(rspec)


@pytest.mark.parametrize("policy", ["lru", "prio", "random"])
def test_set_assoc_cache_equals_the_reference(policy):
    kw = dict(size=8 * KiB, line=32, sets=4, policy=policy,
              reserved_ways=16 if policy == "prio" else 0, seed=3)
    port, ref = simulator.SetAssocCache(**kw), rsim.SetAssocCache(**kw)
    rng = np.random.RandomState(1)
    for a in rng.randint(0, 64 * KiB, 5000):
        assert port.access(int(a)) == ref.access(int(a))
    assert (port.hits, port.misses) == (ref.hits, ref.misses)
