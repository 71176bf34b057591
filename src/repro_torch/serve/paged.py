"""Paged KV cache: host-side page accounting and the page-table gather.

K/V rows live in a shared pool of fixed-size pages and each engine slot
owns a page table. Page 0 is the **null page**: never allocated, it absorbs
writes from freed or idle slots (whose table rows are zeroed) and writes
past a table's reach.

* ``PageAllocator`` — LIFO free list over page ids for one device, with
  the reference's conservation counters. Given the same operations it
  hands out the same page ids as ``repro.serve.paged.PageAllocator`` with
  ``n_devices=1``.
* ``gather_kv`` — the plain page-table walk: materialises the contiguous
  (b, max_pages * page_size, kvh, d) view of a pool.
* ``pages_for`` / ``chunk_page_need`` — the allocation units that
  admission and the chunked-prefill scheduler share.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

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
    """LIFO free list over the KV page pool of one device.

    ``n_pages`` counts the null page, so ``capacity`` is ``n_pages - 1``.
    Invariants: the null page is never handed out, a live page is never
    handed out again, and ``pages_allocated - pages_freed ==
    pages_in_use``. Refcounted sharing (prefix caching) is not ported."""

    n_pages: int
    page_size: int

    def __post_init__(self):
        if self.n_pages < 2:
            raise ValueError("pool needs the null page + 1 real page")
        if self.page_size < 1:
            raise ValueError(f"page_size {self.page_size} < 1")
        # Popped from the end: page 1 is handed out first, and a freed
        # slot's pages are the next ones reused.
        self._free: List[int] = list(range(self.n_pages - 1, NULL_PAGE, -1))
        self.slot_pages: Dict[int, List[int]] = {}
        self._live: set = set()
        self.high_water = 0
        self.pages_allocated = 0
        self.pages_freed = 0

    @property
    def capacity(self) -> int:
        """Allocatable pages: the pool minus the null page."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return len(self._live)

    def can_alloc(self, n: int) -> bool:
        return self.free_pages >= n

    def alloc(self, slot: int, n: int = 1) -> List[int]:
        """Take ``n`` pages for ``slot``; raises ``PagePoolExhausted``
        (allocating nothing) when the free list is short."""
        if self.free_pages < n:
            raise PagePoolExhausted(
                f"need {n} pages for slot {slot}, {self.free_pages} free "
                f"({self.pages_in_use}/{self.capacity} in use)")
        got = [self._free.pop() for _ in range(n)]
        for p in got:
            if p == NULL_PAGE or p in self._live:
                raise AssertionError(f"page {p} handed out twice")
            self._live.add(p)
        self.slot_pages.setdefault(slot, []).extend(got)
        self.pages_allocated += len(got)
        self.high_water = max(self.high_water, self.pages_in_use)
        return got

    def free_slot(self, slot: int) -> List[int]:
        """Return every page of ``slot`` to the free list (in reverse, so
        a re-admission walks them in allocation order again)."""
        pages = self.slot_pages.pop(slot, [])
        for p in reversed(pages):
            self._live.discard(p)
            self._free.append(p)
        self.pages_freed += len(pages)
        return pages

    def occupancy(self) -> dict:
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "capacity": self.capacity,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.free_pages,
            "high_water": self.high_water,
            "pages_allocated": self.pages_allocated,
            "pages_freed": self.pages_freed,
        }


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
