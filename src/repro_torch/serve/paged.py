"""Paged KV cache: host-side page accounting and the page-table gather.

K/V rows live in a shared pool of fixed-size pages and each engine slot
owns a page table. Page 0 is the **null page**: never allocated, it absorbs
writes from freed or idle slots (whose table rows are zeroed) and writes
past a table's reach.

* ``PageAllocator`` — LIFO free lists over page ids, one a device of a
  pool sharded by pages (``n_devices``; global page p on device
  p // block), with refcounts (pages shared by slots and held by the
  prefix index) and the reference's conservation counters. Given the
  same operations it hands out the same page ids as
  ``repro.serve.paged.PageAllocator`` at the same ``n_devices``.
* ``PrefixIndex`` — full-page token prefixes keyed by chained digests,
  mapped to the pages that hold their rows: prefix caching is sharing
  pages through the table, copy-on-write before a write into a shared
  page, and LRU eviction of pages only the index holds.
* ``gather_kv`` — the plain page-table walk: materialises the contiguous
  (b, max_pages * page_size, kvh, d) view of a pool; ``write_rows`` the
  write through the table, the last write winning where writes collide.
* ``pages_for`` / ``chunk_page_need`` — the allocation units that
  admission and the chunked-prefill scheduler share; ``reservation`` the
  modelled rows paged against contiguous.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

NULL_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """No free pages left in the shared KV pool."""


def pages_for(n_rows: int, page_size: int) -> int:
    """Pages needed to hold ``n_rows`` KV rows."""
    return -(-int(n_rows) // page_size)


def chunk_page_need(cursor: int, chunk_rows: int, pages_held: int,
                    page_size: int, max_rows: int) -> int:
    """Pages a slot must *add* before writing rows [cursor, cursor+chunk).

    Rows past ``max_rows`` spill to the null page and need no backing.
    Admission (cursor 0, nothing held) and every later chunk price their
    pages with this one function, so the two can never disagree."""
    end = min(int(cursor) + int(chunk_rows), int(max_rows))
    return max(0, pages_for(end, page_size) - int(pages_held))


@dataclasses.dataclass
class PageAllocator:
    """LIFO free lists over the KV page pool, with refcounts.

    ``n_pages`` counts the null page, so ``capacity`` is ``n_pages - 1``
    on any number of devices: sharding the pool over ``n_devices`` (equal
    blocks of ``block`` pages; global page p on device p // block, local
    page p % block) changes where a page lives, never what a request
    costs. Each device has its own free list, and a page is taken from
    the device with the most free pages (ties to the lowest index), so
    slots stripe across devices and one context can span them.

    A live page is held by one or more slots (``alloc``, ``share``) and at
    most once by the prefix index (``retain``); it returns to its device's
    free list when its count drops to zero. Invariants: the null page is
    never handed out, a live page is never handed out again, every live
    page has a count >= 1, and ``pages_allocated - pages_freed ==
    pages_in_use`` (sharing moves neither)."""

    n_pages: int
    page_size: int
    n_devices: int = 1

    def __post_init__(self):
        if self.n_pages < 2:
            raise ValueError("pool needs the null page + 1 real page")
        if self.page_size < 1:
            raise ValueError(f"page_size {self.page_size} < 1")
        if self.n_devices < 1 or self.n_pages % self.n_devices:
            raise ValueError(f"{self.n_pages} pages do not split over "
                             f"{self.n_devices} devices")
        self.block = self.n_pages // self.n_devices
        # Popped from the end: each device hands out its lowest page
        # first, and a freed page is the next one its device reuses. The
        # null page (device 0, local 0) is in no list.
        self._free_by_dev: List[List[int]] = [
            list(range((d + 1) * self.block - 1, d * self.block - 1, -1))
            for d in range(self.n_devices)]
        self._free_by_dev[0] = list(range(self.block - 1, NULL_PAGE, -1))
        self.slot_pages: Dict[int, List[int]] = {}
        # Holds per live page (slots and the index): its keys are the live
        # pages. A page held by the index alone is cached idle, the class
        # eviction takes.
        self._ref: Dict[int, int] = {}
        self._index_held: set = set()
        self.high_water = 0
        self.pages_allocated = 0
        self.pages_freed = 0
        self.shared_mappings = 0      # pages mapped by share()
        self.index_retains = 0
        self.cow_count = 0

    def device_of(self, page: int) -> int:
        """The device holding global page ``page``."""
        return int(page) // self.block

    def local_of(self, page: int) -> int:
        """Global page ``page``'s index in its device's block."""
        return int(page) % self.block

    @property
    def capacity(self) -> int:
        """Allocatable pages: the pool minus the null page."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free_by_dev)

    @property
    def _free(self) -> List[int]:
        """Every device's free list, joined in device order."""
        return [p for f in self._free_by_dev for p in f]

    @property
    def pages_in_use(self) -> int:
        return len(self._ref)

    def can_alloc(self, n: int) -> bool:
        return self.free_pages >= n

    def alloc(self, slot: int, n: int = 1) -> List[int]:
        """Take ``n`` pages for ``slot``; raises ``PagePoolExhausted``
        (allocating nothing) when the free lists are short."""
        got = self._take(n, f"slot {slot}")
        self.slot_pages.setdefault(slot, []).extend(got)
        return got

    def _take(self, n: int, owner: str) -> List[int]:
        """``n`` fresh pages with one hold each, assigned to no slot
        (``alloc`` and ``cow`` share it), each from the device with the
        most free pages."""
        if self.free_pages < n:
            raise PagePoolExhausted(
                f"need {n} pages for {owner}, {self.free_pages} free "
                f"({self.pages_in_use}/{self.capacity} in use)")
        got = []
        for _ in range(n):
            dev = max(range(self.n_devices),
                      key=lambda d: (len(self._free_by_dev[d]), -d))
            got.append(self._free_by_dev[dev].pop())
        for p in got:
            if p == NULL_PAGE or p in self._ref:
                raise AssertionError(f"page {p} handed out twice")
            self._ref[p] = 1
        self.pages_allocated += len(got)
        self.high_water = max(self.high_water, self.pages_in_use)
        return got

    def share(self, slot: int, pages: Sequence[int]) -> None:
        """Map live ``pages`` into ``slot`` by adding a hold to each: a
        prefix-cache hit, which moves no data."""
        pages = [int(p) for p in pages]
        for p in pages:
            if self._ref.get(p, 0) < 1:
                raise AssertionError(f"share of page {p}, which is not live")
            self._ref[p] += 1
        self.slot_pages.setdefault(slot, []).extend(pages)
        self.shared_mappings += len(pages)

    def retain(self, page: int) -> None:
        """The prefix index's hold on a live page (one at most)."""
        page = int(page)
        if page not in self._ref or page in self._index_held:
            raise AssertionError(f"retain of page {page}")
        self._ref[page] += 1
        self._index_held.add(page)
        self.index_retains += 1

    def release(self, page: int) -> bool:
        """Drop the index's hold; True when that freed the page."""
        page = int(page)
        if page not in self._index_held:
            raise AssertionError(f"release of page {page}, not retained")
        self._index_held.discard(page)
        return self._decref(page)

    def refcount(self, page: int) -> int:
        return self._ref.get(int(page), 0)

    def _decref(self, page: int) -> bool:
        """Drop one hold; a page whose last hold went returns to the free
        list. True when freed."""
        if self._ref.get(page, 0) < 1:
            raise AssertionError(f"decref of page {page}, which is not live")
        self._ref[page] -= 1
        if self._ref[page]:
            return False
        del self._ref[page]
        self._free_by_dev[self.device_of(page)].append(page)
        self.pages_freed += 1
        return True

    def cow(self, slot: int, pos: int) -> Tuple[int, int]:
        """Copy-on-write split: the shared page at table position ``pos``
        of ``slot`` is replaced by a fresh page held by the slot alone.
        Returns ``(old, new)``; the caller copies the rows on the device
        and updates the table. Raises ``PagePoolExhausted`` (changing
        nothing) when no page is free."""
        old = self.slot_pages[slot][pos]
        if self._ref.get(old, 0) < 2:
            raise AssertionError(f"copy-on-write of unshared page {old}")
        new = self._take(1, f"copy-on-write of slot {slot}")[0]
        self.slot_pages[slot][pos] = new
        self._decref(old)                       # held twice: never frees
        self.cow_count += 1
        return old, new

    def free_slot(self, slot: int) -> List[int]:
        """Drop ``slot``'s hold on every page it maps (in reverse, so a
        re-admission walks them in allocation order again); returns the
        pages that freed. Pages another holder keeps stay live."""
        freed = [p for p in reversed(self.slot_pages.pop(slot, []))
                 if self._decref(p)]
        freed.reverse()
        return freed

    def reset(self) -> None:
        """Free everything and zero the counters (an engine restart)."""
        self.__post_init__()

    def rows_resident(self) -> int:
        """K/V rows the pool holds live, the null page included."""
        return (self.pages_in_use + 1) * self.page_size

    def device_occupancy(self) -> List[int]:
        """Live pages a device; sums to ``pages_in_use``."""
        occ = [0] * self.n_devices
        for p in self._ref:
            occ[self.device_of(p)] += 1
        return occ

    def page_classes(self) -> Dict[str, int]:
        """Live pages by sharing state: ``exclusive`` (one slot, no index
        hold), ``shared`` (two holds or more), ``cached_idle`` (the
        index's hold alone: what eviction takes). Sums to
        ``pages_in_use``."""
        exclusive = shared = cached_idle = 0
        for p, r in self._ref.items():
            if r >= 2:
                shared += 1
            elif p in self._index_held:
                cached_idle += 1
            else:
                exclusive += 1
        return {"pages_exclusive": exclusive, "pages_shared": shared,
                "pages_cached_idle": cached_idle}

    def occupancy(self, lengths: Optional[Dict[int, int]] = None) -> dict:
        """The pool's counters; with per-slot ``lengths`` (rows each slot
        holds) also the internal fragmentation: rows its pages hold but no
        slot uses (``fragmentation_rows``), and their share of the rows
        allocated (``fragmentation_frac``)."""
        out = {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "capacity": self.capacity,
            "n_devices": self.n_devices,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.free_pages,
            "high_water": self.high_water,
            "pages_allocated": self.pages_allocated,
            "pages_freed": self.pages_freed,
            "utilization": self.pages_in_use / max(1, self.capacity),
            "rows_resident": self.rows_resident(),
            "shared_mappings": self.shared_mappings,
            "index_retains": self.index_retains,
            "cow_count": self.cow_count,
        }
        out.update(self.page_classes())
        if self.n_devices > 1:
            out["pages_in_use_by_device"] = self.device_occupancy()
        if lengths is not None:
            alloc_rows = sum(len(ps) * self.page_size
                             for ps in self.slot_pages.values())
            unused = alloc_rows - sum(int(n) for n in lengths.values())
            out["fragmentation_rows"] = unused
            out["fragmentation_frac"] = unused / max(1, alloc_rows)
        return out


# ----------------------------------------------------------------------------
# Prefix index: full-page token prefixes -> resident pages
# ----------------------------------------------------------------------------

ROOT_DIGEST = b""
_DIGEST_BYTES = 16


def _page_digest(parent: bytes, chunk: bytes) -> bytes:
    """Chained digest of one full page of tokens: the parent's digest is
    hashed in, so a key stands for the whole prefix up to this page."""
    return hashlib.blake2b(parent + chunk, digest_size=_DIGEST_BYTES).digest()


def token_bytes(tokens) -> bytes:
    """A token run as int32 little-endian bytes, whatever its integer
    type: the engine holds tokens as int64, the reference as int32, and
    both must hash alike."""
    return np.ascontiguousarray(np.asarray(tokens, "<i4")).tobytes()


@dataclasses.dataclass
class _PrefixEntry:
    page: int          # the page holding this prefix's last full page
    parent: bytes      # digest of the prefix one page shorter (or ROOT)
    tokens: bytes      # the page's tokens, compared on every probe
    children: int      # live entries that extend this prefix by a page
    last_used: int     # tick of the last hit or publish (LRU)


class PrefixIndex:
    """Full-page token prefixes -> resident pages, evicted LRU.

    Each entry holds one ``retain`` on its page, so a published page
    outlives its writer (cached idle) until ``evict`` releases it. Only
    leaves held by the index alone are evicted: an interior entry backs
    longer prefixes, a page a slot maps backs a live stream. A probe
    compares each page's stored tokens, so a digest collision is a miss,
    never a wrong share."""

    def __init__(self, pool: PageAllocator):
        self.pool = pool
        self.page_size = pool.page_size
        self._entries: Dict[bytes, _PrefixEntry] = {}
        self.evicted_pages = 0

    def __len__(self) -> int:
        return len(self._entries)

    def probe(self, tokens, max_pages: int,
              now: int = 0) -> Tuple[List[int], bytes, int]:
        """Longest cached prefix of ``tokens`` in whole pages, at most
        ``max_pages``: ``(pages, digest of the deepest match, n_hit)``."""
        ps = self.page_size
        pages: List[int] = []
        parent = ROOT_DIGEST
        for i in range(min(len(tokens) // ps, int(max_pages))):
            chunk = token_bytes(tokens[i * ps:(i + 1) * ps])
            digest = _page_digest(parent, chunk)
            e = self._entries.get(digest)
            if e is None or e.tokens != chunk:
                break
            e.last_used = now
            pages.append(e.page)
            parent = digest
        return pages, parent, len(pages)

    def publish(self, tokens, page: int, parent: bytes,
                now: int = 0) -> Optional[bytes]:
        """Register one full page of ``tokens`` extending ``parent``,
        held in ``page``. An existing entry wins (the caller's page stays
        its own); a digest whose stored tokens differ refuses and returns
        None. Otherwise returns the digest the next page extends."""
        chunk = token_bytes(tokens)
        if len(chunk) != 4 * self.page_size:
            raise ValueError("publish takes one full page of tokens")
        digest = _page_digest(parent, chunk)
        e = self._entries.get(digest)
        if e is not None:
            if e.tokens != chunk:
                return None
            e.last_used = now
            return digest
        self.pool.retain(page)
        if parent != ROOT_DIGEST and parent in self._entries:
            self._entries[parent].children += 1
        self._entries[digest] = _PrefixEntry(page=int(page), parent=parent,
                                             tokens=chunk, children=0,
                                             last_used=now)
        return digest

    def evict(self, n_pages: int, now: int = 0, keep=()) -> int:
        """Release up to ``n_pages`` cached-idle leaves, least recently
        used first (a freed leaf can make its parent one), never a page
        in ``keep``; returns the pages freed."""
        keep = set(keep)
        freed = 0
        while freed < n_pages:
            best = None
            for digest, e in self._entries.items():
                if e.children or self.pool.refcount(e.page) != 1 \
                        or e.page in keep:
                    continue
                if best is None or e.last_used < best[1].last_used:
                    best = (digest, e)
            if best is None:
                break
            digest, e = best
            del self._entries[digest]
            if e.parent != ROOT_DIGEST and e.parent in self._entries:
                self._entries[e.parent].children -= 1
            self.pool.release(e.page)
            freed += 1
        self.evicted_pages += freed
        return freed

    def clear(self) -> int:
        """Drop every entry; returns the pages that freed."""
        freed = sum(self.pool.release(e.page) for e in self._entries.values())
        self._entries.clear()
        return freed


def last_writers(page: torch.Tensor, row: torch.Tensor, page_size: int,
                 pool_rows: int) -> torch.Tensor:
    """For writes to pool rows (page, row) (any shape, int) of a pool of
    ``pool_rows`` rows: the flat index of the last write to each one's
    pool row (its own where no later write shares it). A max scattered
    over the pool's rows, exact whatever order the atomics land in; no
    step waits on the host, so a captured graph runs it."""
    target = page.reshape(-1).long() * page_size + row.reshape(-1).long()
    order = torch.arange(target.numel(), device=target.device)
    last = torch.zeros(pool_rows, dtype=torch.long, device=target.device)
    return last.scatter_reduce_(0, target, order, "amax")[target]


def write_rows(kp: torch.Tensor, vp: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, page: torch.Tensor, row: torch.Tensor,
               src: Optional[torch.Tensor] = None) -> None:
    """Write K/V rows (b, s, kvh, d) into the pool (n_pages, page_size,
    kvh, d) at (page, row) (b, s), in place. Writes that land on one pool
    row (the null page's: free slots, padded chunk rows, rows past a
    table's reach) all carry the last one's values (``src``, the
    ``last_writers`` of (page, row), computed here where not given), so
    the row holds the last write, as an in-order scatter leaves it, and
    not whichever write a card's threads finish last: garbage rows read
    it back, and their tokens route through a mixture's capacity ahead of
    later slots' tokens."""
    if src is None:
        src = last_writers(page, row, kp.shape[1],
                           kp.shape[0] * kp.shape[1])
    page, row = page.reshape(-1), row.reshape(-1)
    kp[page, row] = k.reshape(-1, *k.shape[2:])[src].to(kp.dtype)
    vp[page, row] = v.reshape(-1, *v.shape[2:])[src].to(vp.dtype)


def gather_kv(kp: torch.Tensor, vp: torch.Tensor, pages: torch.Tensor):
    """Materialise the contiguous view of a paged pool.

    kp/vp: (n_pages, page_size, kvh, d); pages: (b, max_pages) int with
    0 = null page. Returns (b, max_pages * page_size, kvh, d) each; rows
    mapped through the null page are garbage the caller masks."""
    b, max_pages = pages.shape
    ps = kp.shape[1]
    idx = pages.long()
    kc = kp[idx].reshape(b, max_pages * ps, *kp.shape[2:])
    vc = vp[idx].reshape(b, max_pages * ps, *vp.shape[2:])
    return kc, vc


def reservation(lengths, max_len: int, page_size: int) -> dict:
    """Modelled K/V rows of one layer, paged against contiguous, for
    slots of live context ``lengths``: contiguous reserves ``max_len``
    rows a slot, paged the pages the contexts touch (and the null
    page)."""
    lengths = [int(n) for n in lengths]
    rows_paged = (sum(pages_for(n, page_size) for n in lengths) + 1) \
        * page_size
    rows_contig = len(lengths) * max_len
    return {"page_size": page_size, "slots": len(lengths),
            "rows_resident": rows_paged,
            "rows_reserved_contig": rows_contig,
            "reservation_ratio": rows_paged / max(1, rows_contig)}
