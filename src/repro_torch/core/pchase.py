"""Pointer-chase dissection algorithms (paper ch. 3, after Mei & Chu [12]).

A copy of ``repro/core/pchase.py``: the same detectors with the same
thresholds, giving the same answers on the same device model. Every routine
treats the device as a black box offering only ``flush()`` and
``scan(addrs) -> int64 latencies`` (``Hierarchy``), and infers geometry
purely from timing, as the paper does on silicon. Two devices offer it: the
numpy model ``simulator.MemoryHierarchy`` and the H100 itself through a
clock-timed chase, ``card.CardHierarchy``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Protocol, Sequence, Tuple

import numpy as np


class Hierarchy(Protocol):
    """What a detector asks of a device: ``flush()`` returns it to a cold
    state; ``scan(addrs)`` loads each byte address in order and returns
    each load's latency in cycles (int64)."""

    def flush(self) -> None: ...

    def scan(self, addrs: np.ndarray) -> np.ndarray: ...


# --------------------------------------------------------------------------
# Generic helpers
# --------------------------------------------------------------------------

def measure_hit_latency(hier: Hierarchy, stride: int) -> int:
    """Steady-state latency of a trivially cache-resident scan."""
    addrs = np.arange(0, 16 * stride, stride, dtype=np.int64)
    hier.flush()
    hier.scan(addrs)
    return int(hier.scan(addrs).min())


def _second_scan_miss_fraction(hier: Hierarchy, n_bytes: int,
                               stride: int, hit_latency: int) -> float:
    """Scan [0, n_bytes) twice; fraction of second-scan accesses slower than
    a known-resident access (= cache misses). The paper's Table 3.3
    benchmark."""
    addrs = np.arange(0, n_bytes, stride, dtype=np.int64)
    hier.flush()
    hier.scan(addrs)                       # warm
    lat = hier.scan(addrs)                 # measure
    return float(np.mean(lat > hit_latency))


def detect_size(hier: Hierarchy, lo: int, hi: int, stride: int,
                resolution: int = 1024, threshold: float = 0.005) -> int:
    """Largest array size with (almost) no second-scan misses.

    Monotone in size for LRU and for Volta's priority policy alike, so a
    bracket + binary search replaces the paper's exhaustive sweep (same
    answer, fewer simulated cycles).
    """
    hit_lat = measure_hit_latency(hier, stride)

    def frac(n: int) -> float:
        return _second_scan_miss_fraction(hier, n, stride, hit_lat)

    if frac(lo) > threshold:
        return 0
    # Bracket: double until misses appear.
    good, bad = lo, None
    size = lo
    while size < hi:
        size = min(size * 2, hi)
        if frac(size) > threshold:
            bad = size
            break
        good = size
    if bad is None:
        return good
    while bad - good > resolution:
        mid = (good + bad) // 2
        if frac(mid) > threshold:
            bad = mid
        else:
            good = mid
    return good


def detect_line(hier: Hierarchy, detected_size: int,
                probe_stride: int = 8) -> int:
    """Line size = periodicity of misses in a fine-grained cold scan
    (Fig 3.2: one slow access per line, fast hits inside the line)."""
    n = min(detected_size // 2, 64 * 1024)
    addrs = np.arange(0, n, probe_stride, dtype=np.int64)
    hier.flush()
    lat = hier.scan(addrs)
    lo = lat.min()
    miss_idx = np.nonzero(lat > lo)[0]
    if len(miss_idx) < 2:
        return probe_stride
    gaps = np.diff(miss_idx)
    period = int(np.bincount(gaps).argmax())
    return period * probe_stride


def detect_ways(hier: Hierarchy, size_hint: int, miss_threshold: int,
                max_ways: int = 512) -> int:
    """Effective associativity: chase k addresses spaced by the cache size —
    they all map to one set. The largest k with a clean second scan is the
    (effective) way count. ``miss_threshold`` separates this level's hits
    from its misses (TLB-side latency noise stays below it)."""
    lo_ok, hi_bad = 1, None
    k = 1
    while k <= max_ways:
        k = min(k * 2, max_ways + 1)
        if _same_set_misses(hier, size_hint, k, miss_threshold):
            hi_bad = k
            break
        lo_ok = k
    if hi_bad is None:
        return lo_ok
    while hi_bad - lo_ok > 1:
        mid = (lo_ok + hi_bad) // 2
        if _same_set_misses(hier, size_hint, mid, miss_threshold):
            hi_bad = mid
        else:
            lo_ok = mid
    return lo_ok


def _same_set_misses(hier: Hierarchy, spacing: int, k: int,
                     miss_threshold: int) -> bool:
    addrs = np.arange(k, dtype=np.int64) * spacing
    hier.flush()
    hier.scan(addrs)
    lat = hier.scan(addrs)
    return bool(np.any(lat >= miss_threshold))


def detect_policy(detected_size: int, nominal_size: int) -> str:
    """Table 3.3's observable: a detectable size short of nominal reveals a
    non-LRU preservation-priority policy (Volta / Kepler); matching sizes are
    consistent with LRU."""
    return "non-LRU" if detected_size < nominal_size * 97 // 100 else "LRU"


# --------------------------------------------------------------------------
# Latency classes (Fig 3.2)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LatencyClasses:
    l1_hit: int
    l2_hit: int
    dram: int
    cold: int


def measure_next_level_latency(hier: Hierarchy, level_size: int,
                               stride: int = 8) -> int:
    """Steady-state latency one level below: scan an array several times the
    detected capacity twice — the first level thrashes (LRU) or overflows
    (priority policy), so the slow class of the second scan is the next
    level's hit latency. Needed where L1 and L2 share a line size and the
    cold-scan classes of Fig 3.2 collapse (P100/P4/M60/K80)."""
    addrs = np.arange(0, 4 * level_size, stride, dtype=np.int64)
    hier.flush()
    hier.scan(addrs)
    return int(hier.scan(addrs).max())


def latency_classes(hier: Hierarchy, span: int = 256 * 1024,
                    stride: int = 8) -> LatencyClasses:
    """Cold fine-grained scan: the distinct latencies observed are the cache
    hit/miss classes (28 / 193 / 375 / 1029 on V100)."""
    addrs = np.arange(0, span, stride, dtype=np.int64)
    hier.flush()
    lat = hier.scan(addrs)
    classes = np.unique(lat)
    l1_hit = int(classes[0])
    cold = int(lat[0])
    mids = [int(c) for c in classes if l1_hit < c < cold]
    l2_hit = mids[0] if mids else cold
    dram = mids[1] if len(mids) > 1 else l2_hit
    return LatencyClasses(l1_hit=l1_hit, l2_hit=l2_hit, dram=dram, cold=cold)


# --------------------------------------------------------------------------
# TLB dissection (§3.8, Fig 3.12)
# --------------------------------------------------------------------------

def _tlb_round(hier: Hierarchy, n_pages: int,
               stride: int) -> np.ndarray:
    addrs = np.arange(n_pages, dtype=np.int64) * stride
    hier.flush()
    hier.scan(addrs)           # warm TLB + caches
    return hier.scan(addrs)


def _tlb_round_latency(hier: Hierarchy, n_pages: int,
                       stride: int) -> float:
    return float(_tlb_round(hier, n_pages, stride).mean())


def detect_tlb_entries(hier: Hierarchy, page_stride: int,
                       baseline: float, max_pages: int = 600) -> Tuple[int, float]:
    """Largest page count chaseable at ``page_stride`` without leaving the
    steady-state latency ``baseline``: that is the level's entry count.
    Returns (entries, latency_after_the_jump)."""
    good, bad = 1, None
    n = 1
    while n < max_pages:
        n = min(n * 2, max_pages)
        if _tlb_round_latency(hier, n, page_stride) > baseline + 2.0:
            bad = n
            break
        good = n
    if bad is None:
        return good, baseline
    while bad - good > 1:
        mid = (good + bad) // 2
        if _tlb_round_latency(hier, mid, page_stride) > baseline + 2.0:
            bad = mid
        else:
            good = mid
    return good, _tlb_round_latency(hier, bad, page_stride)


def detect_page_size(hier: Hierarchy, candidates: Sequence[int],
                     elevated_threshold: float, n_probe: int = 512) -> int:
    """Smallest stride at which (essentially) every access of a
    beyond-coverage sweep pays this level's TLB miss. At half the true page
    size, pairs of accesses share an entry and only half the accesses are
    elevated, so the 0.9 fraction test singles out the page size."""
    for stride in sorted(candidates):
        lat = _tlb_round(hier, n_probe, stride)
        frac = float(np.mean(lat > elevated_threshold))
        if frac > 0.9:
            return stride
    return max(candidates)


def dissect_tlbs(hier: Hierarchy,
                 page_candidates_l1: Sequence[int],
                 page_candidates_l2: Sequence[int],
                 max_pages: int = 600) -> List["DiscoveredTLB"]:
    """Full two-level TLB dissection (Fig 3.12): page sizes then coverages.

    ``hier`` must have the L1 data cache disabled (the paper uses ld.global.cg
    for the same reason: L1 is virtually indexed and would mask TLB traffic);
    on the card, ``CardHierarchy(bypass_l1=True)``.
    """
    base = _tlb_round_latency(hier, 2, min(page_candidates_l1))
    page1 = detect_page_size(hier, page_candidates_l1,
                             elevated_threshold=base + 2.0)
    entries1, plateau2 = detect_tlb_entries(hier, page1, base, max_pages)
    l1 = DiscoveredTLB(page_entry=page1, coverage=entries1 * page1)
    page2 = detect_page_size(hier, [c for c in page_candidates_l2 if c >= page1],
                             elevated_threshold=plateau2 + 2.0)
    entries2, _ = detect_tlb_entries(hier, page2, plateau2, max_pages)
    l2 = DiscoveredTLB(page_entry=page2, coverage=entries2 * page2)
    return [l1, l2]


# --------------------------------------------------------------------------
# Full-geometry record
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DiscoveredCache:
    size: int
    line: int
    ways: int
    sets: int
    policy: str
    hit_latency: int


@dataclasses.dataclass
class DiscoveredTLB:
    page_entry: int
    coverage: int
