"""The paper's dissection run on the card: the ch.3 detectors against the H100.

This module has no counterpart in the reference. The reference runs its
detectors (``core/pchase.py``) against a numpy device model because its
machine has no GPU; the port has the card, so here the device under test is
the card itself, as in the paper.

* ``CardHierarchy`` offers the interface of ``simulator.MemoryHierarchy``
  (``flush()``, ``scan(addrs)``, ``chase(...)``) over the clock-timed chase
  kernel (``kernels.ops.pchase_timed``), so every detector of
  ``core.pchase`` runs on it unchanged.
* ``ClassSnapper`` is the rule that turns raw ``clock64`` deltas, which
  jitter by a few cycles, into the exact latency classes the detectors'
  thresholds assume.
* ``dissect_card()`` runs the detectors on the card with bounds taken from
  the card (``hwmodel.H100`` and ``torch.cuda.mem_get_info``) and returns a
  ``CardReport``: the H100's column of Table 3.1, Table 3.3 (the L1 size at
  several shared-memory carveouts), and the latency classes in cycles and
  in nanoseconds at the SM clock measured in the same run.

How the card keeps state between the detectors' calls
------------------------------------------------------
A detector calls ``flush()``, then ``scan(addrs)`` once (a cold scan) or
twice (warm, then measure), and expects the second scan to find the caches
as the first left them. The SM's L1 need not survive a kernel boundary, so
each ``scan`` is one launch that replays every scan since the last
``flush()`` untimed and times only the last: the k-th scan of a list of n
addresses walks (k - 1) * n steps, then n timed ones. The addresses are
laid out as one circular chain (slot ``a // 8`` holds the next address), so
the walk visits them in order, every time round. That needs the addresses
of one scan to be distinct (a repeat would close the cycle early), and all
scans since a flush to repeat one list: ``scan`` raises otherwise. Every
detector of ``core.pchase`` keeps to both.

What ``flush()`` does on the card
---------------------------------
``flush()`` forgets the scans since the last one; the card is flushed
before every launch (``evict()``), since each launch replays from a cold
state. ``evict()`` reads a buffer of four times the L2 (200 MiB), which
evicts the chain's lines from the 50 MB L2, and then one word of each
64 KiB of a second buffer of 8 GiB, which replaces the TLB
entries of the chain's pages in every TLB level that maps fewer pages than
that. The L1 starts empty at each launch. ``CardReport.evict_ms`` holds
its cost as measured in the run.

The snapping rule
-----------------
See ``ClassSnapper``: within one scan, sorted cycle counts split into
clusters wherever two neighbours lie further apart than
``max(SNAP_ABS, SNAP_REL * lower)``, or where a cluster would grow wider
than ``SNAP_WIDTH`` times its lowest count; each cluster's median joins the
nearest class already known within that tolerance, or becomes a new class;
every count of the cluster is replaced by its class. Classes are never
moved once made, so one hierarchy (or several sharing one snapper) reports
one value for one class in every scan. Each position's count is first the
median over ``repeats`` launches, which removes a single slow outlier.
On the H100 (``PERF.md``) an L2 hit jitters over about 290-360 cycles with
the address, and an L1 hit not at all; steps smaller than ``SNAP_REL`` of a
class (about 45 cycles at the L2's) are below the rule's resolution.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dissect, hwmodel, pchase
from repro_torch.kernels import ops

KiB = hwmodel.KiB
MiB = hwmodel.MiB
GiB = 1024 * MiB

# The SM's L1 and shared memory together (Hopper architecture white paper);
# shared memory takes one of these sizes and the L1 the rest (CUDA C++
# programming guide, compute capability 9.0).
L1_PLUS_SMEM = 256 * KiB
SMEM_CONFIGS = tuple(k * KiB for k in (0, 8, 16, 32, 64, 100, 132, 164, 196,
                                       228))

SNAP_ABS = 8          # cycles
SNAP_REL = 0.15       # of the lower count
SNAP_WIDTH = 1.3      # the widest cluster, highest over lowest count

EVICT_L2_BYTES = 4 * hwmodel.H100.l2_bytes
EVICT_TLB_BYTES = 8 * GiB
EVICT_PAGE = 64 * KiB


class ClassSnapper:
    """Snaps raw cycle counts to latency classes (see the module docstring).

    ``tolerance(c) = max(SNAP_ABS, SNAP_REL * c)``. ``classes`` lists the
    classes made so far, in the order they were made."""

    def __init__(self):
        self.classes: List[int] = []

    @staticmethod
    def tolerance(c: float) -> float:
        return max(SNAP_ABS, SNAP_REL * c)

    def clusters(self, raw: np.ndarray) -> List[Tuple[int, int, int]]:
        """(lowest, highest, median) of each cluster of ``raw``, rising."""
        v = np.sort(np.asarray(raw, dtype=np.int64))
        if v.size == 0:
            return []
        tol = np.maximum(SNAP_ABS, SNAP_REL * v[:-1])
        gaps = np.append(np.nonzero(np.diff(v) > tol)[0] + 1, v.size)
        out, lo = [], 0
        while lo < v.size:
            end = min(int(gaps[np.searchsorted(gaps, lo, side="right")]),
                      int(np.searchsorted(v, SNAP_WIDTH * v[lo],
                                          side="right")))
            out.append((int(v[lo]), int(v[end - 1]),
                        int(v[(lo + end - 1) // 2])))
            lo = end
        return out

    def class_of(self, median: int) -> int:
        near = [c for c in self.classes
                if abs(c - median) <= self.tolerance(min(c, median))]
        if near:
            return min(near, key=lambda c: abs(c - median))
        self.classes.append(median)
        return median

    def snap(self, raw: np.ndarray) -> np.ndarray:
        raw = np.asarray(raw, dtype=np.int64)
        out = np.empty_like(raw)
        for lo, hi, med in self.clusters(raw):
            out[(raw >= lo) & (raw <= hi)] = self.class_of(med)
        return out


def _check_addrs(addrs) -> np.ndarray:
    a = np.asarray(addrs, dtype=np.int64).ravel()
    if a.size == 0:
        raise ValueError("scan of no address")
    if (a < 0).any() or (a % 8).any():
        raise ValueError("scan addresses must be non-negative multiples of "
                         "8 (one 8-byte chain slot each)")
    if np.unique(a).size != a.size:
        raise ValueError("a scan's addresses must be distinct: the card "
                         "walks them as one circular chain")
    return a


def chain_of(addrs: np.ndarray, n_slots: int) -> np.ndarray:
    """The circular chain that visits ``addrs`` in order: slot ``a // 8``
    of each address holds the next address, the last the first; the other
    slots hold 0."""
    a = _check_addrs(addrs)
    chain = np.zeros(n_slots, dtype=np.int64)
    chain[a // 8] = np.roll(a, -1)
    return chain


class ReplayHierarchy:
    """``flush``/``scan`` as the detectors use them, over a device that
    walks a chain from a cold state: each ``scan`` lays its addresses out
    as one circular chain (``load``) at the first scan after a flush, and
    has the device replay the earlier scans untimed before timing its own
    (``walk``). Subclasses say how; ``CardHierarchy`` does it on the card,
    and the CPU tests over the device model."""

    def __init__(self):
        self._addrs: Optional[np.ndarray] = None
        self._scans = 0

    def load(self, addrs: np.ndarray) -> None:
        """Lay ``addrs`` out as the chain ``chain_of`` builds."""
        raise NotImplementedError

    def walk(self, start: int, warm: int, steps: int) -> np.ndarray:
        """From a cold device, ``warm`` untimed steps of the chain from
        ``start``, then the latencies of ``steps`` timed ones (int64)."""
        raise NotImplementedError

    def flush(self) -> None:
        self._addrs = None
        self._scans = 0

    def scan(self, addrs) -> np.ndarray:
        a = _check_addrs(addrs)
        if self._addrs is None:
            self.load(a)
            self._addrs = a
        elif not np.array_equal(a, self._addrs):
            raise ValueError("the scans since a flush() must repeat one "
                             "address list: the card replays them as one "
                             "chain")
        lat = self.walk(int(a[0]), self._scans * a.size, a.size)
        self._scans += 1
        return lat


class CardHierarchy(ReplayHierarchy):
    """``flush``/``scan``/``chase`` of ``simulator.MemoryHierarchy`` on the
    card (see the module docstring for what each does there); latencies
    are classes of ``snapper``.

    ``bypass_l1`` loads with ``ld.global.cg``, as the paper does for the L2
    and the TLB sweeps. ``carveout`` is the chase kernel's preferred
    shared-memory carveout in percent (0 leaves the L1 its largest size).
    ``repeats`` launches per scan, each from an evicted card; the counts
    are their median. On the CPU it raises: there is no card to dissect,
    and the device models (``simulator.MemoryHierarchy``) run there."""

    def __init__(self, device=None, bypass_l1: bool = False,
                 carveout: int = 0, repeats: int = 3,
                 snapper: Optional[ClassSnapper] = None):
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise RuntimeError(
                "CardHierarchy times loads on a CUDA card; on the CPU the "
                "device models run (simulator.MemoryHierarchy)")
        if repeats < 1:
            raise ValueError(f"repeats must be at least 1, got {repeats}")
        super().__init__()
        self.device, self.bypass_l1 = dev, bypass_l1
        self.carveout, self.repeats = carveout, repeats
        self.snapper = snapper or ClassSnapper()
        self.arena: Optional[torch.Tensor] = None
        self._l2buf = self._tlbbuf = None
        self.evictions = 0
        self.evict_seconds = 0.0

    def chase(self, chain: np.ndarray, start: int = 0, steps: int = 0,
              flush: bool = False) -> np.ndarray:
        """``simulator.MemoryHierarchy.chase`` on the card: follow the
        int64 byte-offset ``chain`` from ``start`` for ``steps`` loads
        (all of it by default), after an ``evict()`` if ``flush``;
        returns each load's class. Without ``flush`` the L2 and the TLBs
        hold what earlier launches left. The offsets the kernel visited
        must be the chain's own, or it raises."""
        steps = steps or len(chain)
        t = torch.from_numpy(np.ascontiguousarray(chain, np.int64)).to(
            self.device)
        if flush:
            self.evict()
        got, cycles, _ = ops.pchase_timed(t, steps, start=start,
                                          bypass_l1=self.bypass_l1,
                                          carveout=self.carveout)
        got = got.cpu().numpy()
        if got[0] != start or not np.array_equal(
                got[1:], np.asarray(chain)[got[:-1] // 8]):
            raise RuntimeError("pchase_timed left the chain")
        return self.snapper.snap(cycles.cpu().numpy())

    # -- the card ---------------------------------------------------------

    def load(self, a: np.ndarray) -> None:
        slots = int(a.max()) // 8 + 1
        if self.arena is None or self.arena.shape[0] < slots:
            self.arena = None
            torch.cuda.empty_cache()
            round_to = 2 * MiB // 8
            self.arena = torch.zeros(-(-slots // round_to) * round_to,
                                     dtype=torch.int64, device=self.device)
        idx = torch.from_numpy(a // 8).to(self.device)
        self.arena[idx] = torch.from_numpy(np.roll(a, -1)).to(self.device)

    def evict(self) -> None:
        """Evict the L2 and the TLB entries (see the module docstring)."""
        t0 = time.perf_counter()
        if self._l2buf is None:
            self._l2buf = torch.ones(EVICT_L2_BYTES // 8, dtype=torch.int64,
                                     device=self.device)
            self._tlbbuf = torch.ones(EVICT_TLB_BYTES // 8,
                                      dtype=torch.int64, device=self.device)
        self._l2buf.sum()
        self._tlbbuf.view(-1, EVICT_PAGE // 8)[:, 0].sum()
        torch.cuda.synchronize(self.device)
        self.evictions += 1
        self.evict_seconds += time.perf_counter() - t0

    def walk(self, start: int, warm: int, steps: int) -> np.ndarray:
        """The classes of the per-position median of ``repeats`` launches,
        each after an ``evict()``."""
        runs = []
        for _ in range(self.repeats):
            self.evict()
            _, cycles, _ = ops.pchase_timed(
                self.arena, steps, start=start, warm=warm,
                bypass_l1=self.bypass_l1, offsets=False,
                carveout=self.carveout)
            runs.append(cycles.cpu().numpy().astype(np.int64))
        raw = np.sort(np.stack(runs), axis=0)[(self.repeats - 1) // 2]
        return self.snapper.snap(raw)

    def release(self) -> None:
        """Free the chain and the eviction buffers."""
        self.arena = self._l2buf = self._tlbbuf = None
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# The dissection
# ----------------------------------------------------------------------------

def smem_config(carveout: int) -> int:
    """The shared memory an SM keeps at ``carveout`` percent of its 228 KiB
    (the smallest configuration at least that large)."""
    want = carveout * SMEM_CONFIGS[-1] / 100
    return next(c for c in SMEM_CONFIGS if c >= want)


@dataclasses.dataclass
class CardReport(dissect.DissectionReport):
    """``DissectionReport``'s fields for the card, and what only the card
    has. ``reg_banks``/``reg_bank_width`` are None and
    ``smem_latency_curve`` empty: the card's register file and shared
    memory are not probed. ``matches`` is empty: the card has no published
    Table 3.1 column to match. ``l1.ways``/``l1.sets`` and
    ``l2.ways``/``l2.sets``/``l2.policy`` are None: not probed or not
    judged, each for the reason ``cuts`` gives."""

    carveout: int = 0                  # percent, of the L1 rows
    l1_nominal: int = 0                # L1_PLUS_SMEM minus the shared memory
    table_3_3: Dict[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)          # carveout -> (detected, nominal)
    steady: Dict[str, int] = dataclasses.field(default_factory=dict)
    profile: Dict[int, int] = dataclasses.field(default_factory=dict)
    cold_classes: List[int] = dataclasses.field(default_factory=list)
    classes: List[int] = dataclasses.field(default_factory=list)
    sm_clock_mhz: float = 0.0
    bounds: Dict[str, object] = dataclasses.field(default_factory=dict)
    cuts: List[str] = dataclasses.field(default_factory=list)
    tlb_note: str = ""
    evict_ms: float = 0.0
    launches: int = 0
    seconds: float = 0.0

    def ns(self, cycles: float) -> float:
        return cycles * 1e3 / self.sm_clock_mhz


def measure_sm_clock_mhz(device) -> float:
    """The SM clock in this run: the cycles ``clock64`` counts over the
    whole timed walk of one chase of 200,000 L2-resident loads (the
    kernel's ``total``: the loads and the record stores and loop between
    them), over the launch's time between CUDA events. The events also
    hold the launch and the kernel's few instructions outside the walk,
    a few microseconds against about 35 ms: the clock reads low by that
    share, under 0.1 %."""
    steps = 200_000
    n = 4 * MiB // 128
    chain = torch.from_numpy(chain_of(np.arange(n, dtype=np.int64) * 128,
                                      4 * MiB // 8)).to(device)
    ops.pchase_timed(chain, n, bypass_l1=True, offsets=False)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    _, _, total = ops.pchase_timed(chain, steps, bypass_l1=True,
                                   offsets=False)
    end.record()
    end.synchronize()
    return float(total.item()) / (start.elapsed_time(end) * 1e3)


# What dissect_card sweeps: the carveouts of Table 3.3 (the first in full),
# the L2's stride, the profile's footprints (to four times the L2), and the
# reference's TLB page candidates and page count.
CARVEOUTS = (0, 50, 100)
L2_STRIDE = 128
PROFILE_MIB = (1, 4, 16, 24, 32, 48, 64, 200)
TLB_CANDIDATES = ((64 * KiB, 128 * KiB, 256 * KiB, 512 * KiB, 1 * MiB,
                   2 * MiB, 4 * MiB),
                  (2 * MiB, 4 * MiB, 8 * MiB, 16 * MiB, 32 * MiB, 64 * MiB))
MAX_PAGES = 600


def warm_class(hier, footprint: int, stride: int) -> int:
    """The class of the median load of a warm second scan over
    ``footprint`` bytes at ``stride``: where that footprint sits."""
    addrs = np.arange(0, footprint, stride, dtype=np.int64)
    hier.flush()
    hier.scan(addrs)
    lat = np.sort(hier.scan(addrs))
    return int(lat[lat.size // 2])


def dissect_card(device=None) -> CardReport:
    """The ch.3 detectors on the card. Bounds: the L1 up to twice the SM's
    shared memory (``hwmodel.H100.smem_per_sm``), above the 256 KiB of L1
    and shared memory an SM has; the L2 from 256 KiB to twice
    ``hwmodel.H100.l2_bytes``, scanned at ``L2_STRIDE`` bytes (its line is
    detected at 8); the TLB sweep at the reference's page candidates and
    ``MAX_PAGES``, less any candidate whose ``MAX_PAGES`` pages would not
    fit in the free memory (``torch.cuda.mem_get_info``) beside the
    eviction buffers. Every cut is listed in ``CardReport.cuts``.

    Beyond the detectors it records ``profile``: the class of a warm
    scan's median load at footprints from 1 MiB to four times the L2
    (``PROFILE_MIB``), which shows the near and the far L2 partition and
    device memory apart; ``steady["memory"]`` is its last entry."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("dissect_card dissects a CUDA card; on the CPU "
                           "dissect a device model (core.dissect)")
    t_start = time.perf_counter()
    launches0 = ops.LAUNCHES["pchase_timed"]
    snapper = ClassSnapper()
    h100 = hwmodel.H100
    l1_hi = 2 * h100.smem_per_sm
    l2_lo, l2_hi = 256 * KiB, 2 * h100.l2_bytes
    clock = measure_sm_clock_mhz(dev)
    evict_s = evictions = 0

    def done(h):
        nonlocal evict_s, evictions
        evict_s += h.evict_seconds
        evictions += h.evictions
        h.release()

    # L1 (ld.global.ca), at the first carveout in full, then its size at
    # the others: Table 3.3 on the card.
    cv0 = CARVEOUTS[0]
    h = CardHierarchy(dev, carveout=cv0, snapper=snapper)
    l1_hit = pchase.latency_classes(h, span=4 * KiB).l1_hit
    size = pchase.detect_size(h, lo=2 * KiB, hi=l1_hi, stride=8)
    line = pchase.detect_line(h, size)
    l2_hit = pchase.measure_next_level_latency(h, size)
    nominal = L1_PLUS_SMEM - smem_config(cv0)
    l1 = pchase.DiscoveredCache(size=size, line=line, ways=None, sets=None,
                                policy=pchase.detect_policy(size, nominal),
                                hit_latency=l1_hit)
    cold = pchase.latency_classes(h, span=64 * KiB)
    h.flush()
    cold_classes = sorted(set(h.scan(np.arange(0, 64 * KiB, 8)).tolist()))
    done(h)
    table = {cv0: (size, nominal)}
    for cv in CARVEOUTS[1:]:
        h = CardHierarchy(dev, carveout=cv, snapper=snapper)
        table[cv] = (pchase.detect_size(h, lo=2 * KiB, hi=l1_hi, stride=8),
                     L1_PLUS_SMEM - smem_config(cv))
        done(h)

    # L2 (ld.global.cg), and the footprint profile past it.
    h = CardHierarchy(dev, bypass_l1=True, snapper=snapper)
    l2_line = pchase.detect_line(h, 512 * KiB)
    l2_hit_cg = pchase.measure_hit_latency(h, 8)
    stride = max(l2_line, L2_STRIDE)
    l2_size = pchase.detect_size(h, lo=l2_lo, hi=l2_hi, stride=stride,
                                 resolution=512 * KiB)
    h.repeats = 1
    profile = {mib: warm_class(h, mib * MiB, stride) for mib in PROFILE_MIB}
    done(h)
    l2 = pchase.DiscoveredCache(size=l2_size, line=l2_line, ways=None,
                                sets=None, policy=None,
                                hit_latency=l2_hit_cg)
    cuts = [f"L1 policy from the size gap alone (detect_policy): "
            f"{size / KiB:.1f} KiB is {100 * size / nominal:.1f} % of the "
            f"nominal {nominal // KiB} KiB at carveout {cv0} %, the rule's "
            f"line 97 %; a gap cannot tell a non-LRU policy from an L1 the "
            f"driver keeps smaller than nominal",
            f"L1 ways and sets not probed: detect_ways spaces addresses by "
            f"the detected size to put them in one set, which a size of "
            f"{size / KiB:.1f} KiB (no power of two) does not",
            f"L2 size scanned at a {stride}-byte stride, its line detected "
            f"at 8 bytes; its ways and sets not probed (a hashed L2 puts "
            f"no two addresses in one set by their spacing)",
            f"L2 policy not judged: the detected size is where the near "
            f"class ends, not the L2's {h100.l2_bytes // MiB} MiB, and "
            f"detect_policy would read that gap as a policy",
            "footprint profile: one launch a scan, not the median of 3"]

    # TLBs (ld.global.cg), the reference's candidates cut to free memory.
    cand1, cand2 = map(list, TLB_CANDIDATES)
    free, _ = torch.cuda.mem_get_info(dev)
    room = int(0.9 * free) - EVICT_L2_BYTES - EVICT_TLB_BYTES
    keep2 = [c for c in cand2 if c * MAX_PAGES <= room]
    if keep2 != cand2:
        cuts.append(f"TLB page candidates above {keep2[-1] >> 20} MiB "
                    f"dropped: {MAX_PAGES} pages of them pass the "
                    f"{room / GiB:.1f} GiB free beside the eviction "
                    f"buffers")
    h = CardHierarchy(dev, bypass_l1=True, snapper=snapper)
    tlbs = pchase.dissect_tlbs(h, cand1, keep2, MAX_PAGES)
    done(h)
    flat = [t for t in tlbs if t.coverage >= MAX_PAGES * t.page_entry]
    tlb_note = ("a step at every level" if not flat else
                f"no step found within the bounds at {len(flat)} of "
                f"{len(tlbs)} levels ({MAX_PAGES} pages at strides up "
                f"to {max(cand1 + keep2) >> 20} MiB)")

    return CardReport(
        gpu=torch.cuda.get_device_name(dev), l1=l1, l2=l2, latency=cold,
        tlbs=tlbs, reg_banks=None, reg_bank_width=None,
        smem_latency_curve={}, carveout=cv0, l1_nominal=nominal,
        table_3_3=table,
        steady={"l1_hit": l1_hit, "l2_hit": l2_hit, "l2_hit_cg": l2_hit_cg,
                "memory": profile[PROFILE_MIB[-1]]},
        profile=profile, cold_classes=cold_classes,
        classes=sorted(snapper.classes), sm_clock_mhz=clock,
        bounds={"l1": (2 * KiB, l1_hi), "l2": (l2_lo, l2_hi),
                "l2_stride": stride, "tlb_candidates": (cand1, cand2),
                "max_pages": MAX_PAGES, "free_bytes": free},
        cuts=cuts, tlb_note=tlb_note,
        evict_ms=1e3 * evict_s / max(1, evictions),
        launches=ops.LAUNCHES["pchase_timed"] - launches0,
        seconds=time.perf_counter() - t_start)
