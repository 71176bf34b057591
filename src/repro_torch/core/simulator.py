"""Cycle-level device model of a GPU memory hierarchy.

A copy of ``repro/core/simulator.py``: the same classes and functions give
the same answers on the same inputs. It is the device under test of the
device-model dissection (``core.dissect``): configured from a published
card (``hwmodel.PaperGPUSpec``), and the dissector must recover the
configuration *without looking at it*, only through ``scan()`` timings, as
the paper's p-chase kernels do on silicon. The port also has the card
itself: ``core.card.CardHierarchy`` offers the same ``flush``/``scan``
interface over a clock-timed chase on the H100.

Modeled behaviours (paper sections in parens):

* set-associative caches, LRU / non-LRU("prio") replacement (§3.1, Table 3.3)
* virtual-indexed L1, physical-indexed L2 behind TLBs (§3.8)
* two-level TLBs with page-entry granularity (§3.8, Fig 3.12)
* latency classes 28/193/375/1029 (Fig 3.2)
* shared-memory bank conflicts (§3.6, Fig 3.9)
* constant-cache broadcast vs serialized divergence (§3.4, Fig 3.7)

The model is deliberately *not* a performance model of any card: it is
the faithful-methodology backend.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import hwmodel


class SetAssocCache:
    """A set-associative cache with pluggable replacement policy.

    Policies:
      * ``lru``    — classic least-recently-used.
      * ``prio``   — Volta-like preservation-priority model (§3.1.2): each set
                     reserves ``reserved_ways`` low-priority slots that behave
                     as a bypass once the protected region is full. This
                     reproduces the paper's Table 3.3 observation that the
                     detectable L1 size falls ~7 KiB short of nominal, and its
                     observation that large-array scans survive sparse
                     thrashing better than under LRU.
      * ``random`` — seeded pseudo-random victim (used for constant caches).
    """

    def __init__(self, size: int, line: int, sets: Optional[int] = None,
                 ways: Optional[int] = None, policy: str = "lru",
                 reserved_ways: int = 0, seed: int = 0):
        lines = size // line
        if sets is None and ways is None:
            sets, ways = 1, lines          # fully associative
        elif sets is None:
            sets = lines // ways
        elif ways is None:
            ways = lines // sets
        assert sets * ways == lines, (size, line, sets, ways)
        self.size, self.line, self.sets, self.ways = size, line, sets, ways
        self.policy = policy
        self.reserved_ways = reserved_ways if policy == "prio" else 0
        self.rng = np.random.RandomState(seed)
        self.flush()

    def reset_stats(self):
        self.hits = 0
        self.misses = 0

    def flush(self):
        # Per-set state: tag -> way map plus per-way LRU stamps.
        self._map = [dict() for _ in range(self.sets)]
        self._stamp = np.zeros((self.sets, self.ways), dtype=np.int64)
        self._waytag = np.full((self.sets, self.ways), -1, dtype=np.int64)
        self._free = [list(range(self.ways - self.reserved_ways - 1, -1, -1))
                      for _ in range(self.sets)]
        self.clock = 0
        self.reset_stats()

    def access(self, addr: int) -> bool:
        """Access one byte address; returns True on hit."""
        line_addr = addr // self.line
        s = line_addr % self.sets
        tag = line_addr // self.sets
        self.clock += 1
        w = self._map[s].get(tag)
        if w is not None:
            self.hits += 1
            self._stamp[s, w] = self.clock
            return True
        self.misses += 1
        self._fill(s, tag)
        return False

    def _fill(self, s: int, tag: int):
        if self._free[s]:
            v = self._free[s].pop()
        elif self.policy == "prio":
            # Protected region full: low-priority slots act as a transient
            # bypass — the line is not retained (lowest preservation
            # priority; replaced first).
            return
        elif self.policy == "random":
            v = int(self.rng.randint(self.ways - self.reserved_ways))
            del self._map[s][int(self._waytag[s, v])]
        else:  # lru
            v = int(np.argmin(self._stamp[s, :self.ways - self.reserved_ways]))
            del self._map[s][int(self._waytag[s, v])]
        self._map[s][tag] = v
        self._waytag[s, v] = tag
        self._stamp[s, v] = self.clock


class TLB:
    """Fully-associative LRU TLB over fixed-size page entries."""

    def __init__(self, coverage: int, page_entry: int):
        self.page = page_entry
        self.entries = max(1, coverage // page_entry)
        self.flush()

    def flush(self):
        self._map = {}                      # vpn -> slot
        self._slottag = np.full(self.entries, -1, dtype=np.int64)
        self._stamp = np.zeros(self.entries, dtype=np.int64)
        self._free = list(range(self.entries - 1, -1, -1))
        self.hits = self.misses = self.clock = 0

    def access(self, addr: int) -> bool:
        vpn = addr // self.page
        self.clock += 1
        w = self._map.get(vpn)
        if w is not None:
            self.hits += 1
            self._stamp[w] = self.clock
            return True
        self.misses += 1
        if self._free:
            v = self._free.pop()
        else:
            v = int(np.argmin(self._stamp))
            del self._map[int(self._slottag[v])]
        self._map[vpn] = v
        self._slottag[v] = vpn
        self._stamp[v] = self.clock
        return False


@dataclasses.dataclass
class LatencyConfig:
    """Latency classes of Fig 3.2 (cycles)."""

    l1_hit: int = 28
    l2_hit: int = 193
    dram: int = 375          # L2 miss, TLB hit
    l2_tlb_extra: int = 40   # extra on L1-TLB miss / L2-TLB hit
    walk_extra: int = 654    # extra on full TLB miss (1029 - 375)


class MemoryHierarchy:
    """L1 (virtual-indexed) -> TLBs -> L2 (physical-indexed) -> DRAM."""

    def __init__(self, l1: SetAssocCache, l2: SetAssocCache,
                 l1_tlb: TLB, l2_tlb: TLB, lat: LatencyConfig,
                 l1_enabled: bool = True, caches_enabled: bool = True):
        self.l1, self.l2 = l1, l2
        self.l1_tlb, self.l2_tlb = l1_tlb, l2_tlb
        self.lat = lat
        self.l1_enabled = l1_enabled
        # caches_enabled=False models the paper's TLB sweeps (Fig 3.12):
        # page-entry strides alias into a handful of physical L2 sets, so in
        # steady state every access is an L2 miss and latency isolates the
        # TLB hierarchy on top of the DRAM latency.
        self.caches_enabled = caches_enabled
        self.tlb_accesses = 0

    def flush(self):
        for c in (self.l1, self.l2, self.l1_tlb, self.l2_tlb):
            c.flush()
        self.tlb_accesses = 0

    def access(self, addr: int) -> int:
        """Load one address; returns latency in cycles."""
        if self.caches_enabled and self.l1_enabled and self.l1.access(addr):
            return self.lat.l1_hit                      # virtual-indexed: no TLB
        # L1 miss (or disabled): physical L2 access goes through the TLBs.
        self.tlb_accesses += 1
        extra = 0
        if not self.l1_tlb.access(addr):
            if self.l2_tlb.access(addr):
                extra = self.lat.l2_tlb_extra
            else:
                extra = self.lat.walk_extra
        if self.caches_enabled and self.l2.access(addr):
            return self.lat.l2_hit + extra
        return self.lat.dram + extra

    def scan(self, addrs: np.ndarray) -> np.ndarray:
        """Access a sequence of byte addresses, returning per-access latency."""
        out = np.empty(len(addrs), dtype=np.int64)
        for i, a in enumerate(addrs):
            out[i] = self.access(int(a))
        return out

    def chase(self, chain: np.ndarray, start: int = 0, steps: int = 0,
              flush: bool = False) -> np.ndarray:
        """Pointer-chase through ``chain``: load the element at the current
        address; the loaded value is the next address. Records the latency of
        every dependent load. This is the model-side equivalent of the
        fine-grained p-chase kernel of Mei & Chu used throughout ch. 3."""
        if flush:
            self.flush()
        steps = steps or len(chain)
        out = np.empty(steps, dtype=np.int64)
        pos = start
        for k in range(steps):
            out[k] = self.access(pos)
            pos = int(chain[pos // 8])
        return out


def volta_reserved_ways(spec: hwmodel.PaperGPUSpec) -> int:
    """Volta's ~7 KiB undetectable L1 region (Table 3.3): 7 KiB of lines
    spread across the sets."""
    if spec.l1d.policy != "prio":
        return 0
    lines_short = (7 * 1024) // spec.l1d.line
    return lines_short // (spec.l1d.sets or 1)


def build_hierarchy(spec: hwmodel.PaperGPUSpec,
                    l1_size_override: Optional[int] = None,
                    l1_enabled: bool = True,
                    caches_enabled: bool = True) -> MemoryHierarchy:
    """Build the device model for one GPU column of Table 3.1."""
    l1_size = l1_size_override or spec.l1d.size
    l1 = SetAssocCache(l1_size, spec.l1d.line, sets=spec.l1d.sets,
                       policy=spec.l1d.policy,
                       reserved_ways=volta_reserved_ways(spec))
    l2 = SetAssocCache(spec.l2d.size, spec.l2d.line, ways=spec.l2d.ways or 16,
                       policy="lru")
    lat = LatencyConfig(
        l1_hit=spec.l1d.hit_latency or 28,
        l2_hit=spec.l2d.hit_latency or 193,
        dram=spec.global_latency_l2_miss or 375,
        walk_extra=(spec.global_latency_cold or 1029)
                   - (spec.global_latency_l2_miss or 375),
    )
    return MemoryHierarchy(
        l1, l2,
        TLB(spec.l1_tlb.coverage, spec.l1_tlb.page_entry),
        TLB(spec.l2_tlb.coverage, spec.l2_tlb.page_entry),
        lat, l1_enabled=l1_enabled, caches_enabled=caches_enabled)


# ----------------------------------------------------------------------------
# Shared memory bank model (§3.6, Fig 3.9).
# ----------------------------------------------------------------------------

def smem_conflict_degree(spec: hwmodel.PaperGPUSpec, stride_words: int,
                         warp: int = 32, word: int = 4) -> int:
    """Max number of threads hitting the same bank for a strided warp access."""
    banks = spec.smem_banks
    width = spec.smem_bank_width
    counts = {}
    for t in range(warp):
        byte = t * stride_words * word
        bank = (byte // width) % banks
        counts.setdefault(bank, set()).add(byte // width)
    # Accesses to the same bank but the same word broadcast; distinct words
    # within a bank serialize.
    return max(len(words) for words in counts.values())


def smem_latency(spec: hwmodel.PaperGPUSpec, stride_words: int) -> float:
    """Average shared-memory load latency for a warp with given stride.

    Kepler (8-byte banks) serves two 4-byte words per bank per cycle, so a
    2-way conflict costs nothing (Fig 3.9)."""
    degree = smem_conflict_degree(spec, stride_words)
    per_cycle = 2 if spec.smem_bank_width >= 8 else 1
    serial = -(-degree // per_cycle)   # ceil
    return spec.smem_no_conflict_latency + (serial - 1) * 2.0 * per_cycle


# ----------------------------------------------------------------------------
# Constant cache broadcast model (§3.4, Fig 3.7).
# ----------------------------------------------------------------------------

def constant_latency(spec: hwmodel.PaperGPUSpec, level: str,
                     distinct_addrs: int) -> float:
    """Latency of a warp constant load touching ``distinct_addrs`` distinct
    locations: same-address accesses broadcast, diverging accesses
    serialize."""
    base = {"l1": spec.l1c.hit_latency or 27,
            "l1.5": spec.l15c.hit_latency or 89,
            "l2": 245}[level]
    return base * distinct_addrs


def make_chain(n_bytes: int, stride: int, start: int = 0) -> np.ndarray:
    """Build a circular pointer chain over [start, start+n_bytes) with the
    given byte stride. Element i holds the byte address of element i+1.
    Addresses are 8-byte aligned slots (chain is indexed by addr//8)."""
    n = max(1, n_bytes // stride)
    idx = (start + np.arange(n) * stride) // 8
    chain = np.zeros(int(idx.max()) + 1, dtype=np.int64)
    nxt = np.roll(idx, -1) * 8
    chain[idx] = nxt
    return chain
