"""Paged KV-cache bookkeeping on the symmetric heap (DESIGN.md §15).

The paper's §3.2 symmetric-heap allocator is exactly a paged-KV
allocator waiting to be used: a KV page *is* an offset into one flat
symmetric buffer, identical on every PE.  `PagePool` layers a free list
over the heap's brk discipline — the brk only ever advances page by page
(each new page is one aligned `SymmetricHeap.malloc`), and freed pages
are recycled LIFO from the free list instead of violating the paper's
reverse-order `free` rule.  When every page is free the pool rolls the
brk all the way back (the one legal bulk free), so a drained engine
returns the heap to its initial state.

`PagedKV` adds the per-slot page-table bookkeeping the serving engine
uses: admission reserves a sequence's worst-case pages up front (prompt
+ max_new tokens), so decode can never exhaust the heap mid-flight —
heap pressure surfaces only as admission backpressure, never as a
`HeapError` escaping the engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.heap import Allocation, HeapError, SymmetricHeap

NULL_PAGE = 0


class PagePoolError(RuntimeError):
    """Out of KV pages — admission backpressure, not a crash."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold `n_tokens` positions."""
    return -(-max(int(n_tokens), 0) // int(page_size))


class PagePool:
    """Fixed-size-page allocator: free list over the symmetric heap.

    Page ids are heap offsets divided by the page stride (the heap's brk
    starts at 0 and `page_bytes` is alignment-padded, so every page's
    offset is an exact multiple of the stride).  `reserve_null` grabs
    page 0 at construction as the engine's scratch/null page: page-table
    entries of inactive slots point at it, so masked batch rows have a
    writable target that no valid read ever sees.
    """

    def __init__(self, heap: SymmetricHeap | int, page_bytes: int,
                 reserve_null: bool = True):
        if isinstance(heap, int):
            heap = SymmetricHeap(heap)
        if heap.brk != 0:
            raise PagePoolError("PagePool requires a fresh heap (brk=0)")
        self.heap = heap
        align = heap.default_align
        self.page_bytes = -(-int(page_bytes) // align) * align
        if self.page_bytes <= 0:
            raise PagePoolError("page_bytes must be positive")
        self._free: list[int] = []          # LIFO recycled page ids
        self._allocs: list[Allocation] = []  # heap-order, one per page
        self._live: set[int] = set()
        self.null_page: int | None = None
        if reserve_null:
            self.null_page = self._grow()
            self._live.discard(self.null_page)

    # -- capacity ------------------------------------------------------------
    @property
    def num_pages(self) -> int:
        """Total pages the heap can ever hold (including the null page)."""
        return self.heap.capacity // self.page_bytes

    def pages_available(self) -> int:
        unbacked = (self.heap.capacity - self.heap.brk) // self.page_bytes
        return len(self._free) + unbacked

    def can_alloc(self, n: int) -> bool:
        return self.pages_available() >= n

    def live_pages(self) -> int:
        return len(self._live)

    def occupancy(self) -> float:
        """Fraction of allocatable pages currently live (null page
        excluded from the denominator) — the serve-metrics KV gauge."""
        cap = self.num_pages - (1 if self.null_page is not None else 0)
        return len(self._live) / cap if cap > 0 else 0.0

    def fragmentation(self) -> float:
        """Fraction of the available pages that sit on the recycle list
        rather than in unbacked brk headroom.  High values mean the pool
        is serving from churned pages (LIFO reuse working as intended);
        0.0 means a fresh or fully drained pool."""
        avail = self.pages_available()
        return len(self._free) / avail if avail > 0 else 0.0

    # -- alloc/free ----------------------------------------------------------
    def _grow(self) -> int:
        try:
            a = self.heap.malloc(self.page_bytes)
        except HeapError as e:     # contract: HeapError never escapes
            raise PagePoolError(str(e)) from None
        assert a.offset % self.page_bytes == 0, (a.offset, self.page_bytes)
        self._allocs.append(a)
        pid = a.offset // self.page_bytes
        self._live.add(pid)
        return pid

    def alloc(self, n: int = 1) -> list[int]:
        """Allocate `n` pages (free list first, then brk growth) or raise
        `PagePoolError` leaving the pool unchanged (all-or-nothing, so a
        rejected admission holds no partial reservation)."""
        if not self.can_alloc(n):
            raise PagePoolError(
                f"out of KV pages: want {n}, have {self.pages_available()}")
        got: list[int] = []
        for _ in range(n):
            if self._free:
                pid = self._free.pop()
                self._live.add(pid)
                got.append(pid)
            else:
                got.append(self._grow())
        return got

    def free(self, pages) -> None:
        for pid in pages:
            if pid == self.null_page:
                raise PagePoolError("cannot free the reserved null page")
            if pid not in self._live:
                raise PagePoolError(f"free of unallocated page {pid}")
            self._live.remove(pid)
            self._free.append(pid)
        if not self._live:
            self._trim()

    def _trim(self) -> None:
        """All pages free: the one legal bulk release under the paper's
        brk discipline — free the FIRST post-null allocation, which frees
        the whole series, and start the free list over."""
        keep = 1 if self.null_page is not None else 0
        if len(self._allocs) > keep:
            self.heap.free(self._allocs[keep])
            del self._allocs[keep:]
        self._free = []


@dataclasses.dataclass
class SlotPages:
    rid: int
    pages: list[int]
    n_tokens: int


class PagedKV:
    """Per-slot page tables over a `PagePool`.

    `table` is the dense (max_slots, max_pages) int32 page-table array
    the jitted model indexes; unassigned entries point at the null page.
    """

    def __init__(self, pool: PagePool, max_slots: int, max_pages: int):
        self.pool = pool
        self.max_slots = int(max_slots)
        self.max_pages = int(max_pages)
        null = pool.null_page if pool.null_page is not None else NULL_PAGE
        self.table = np.full((max_slots, max_pages), null, np.int32)
        self._slots: list[SlotPages | None] = [None] * max_slots

    # -- admission / eviction -------------------------------------------------
    def can_admit(self, n_pages: int) -> bool:
        return n_pages <= self.max_pages and self.pool.can_alloc(n_pages)

    def admit(self, slot: int, rid: int, n_pages: int,
              n_tokens: int) -> SlotPages:
        if self._slots[slot] is not None:
            raise PagePoolError(f"slot {slot} already occupied")
        if n_pages > self.max_pages:
            raise PagePoolError(
                f"sequence needs {n_pages} pages > max_pages={self.max_pages}")
        pages = self.pool.alloc(n_pages)
        sp = SlotPages(rid=rid, pages=pages, n_tokens=n_tokens)
        self._slots[slot] = sp
        self.table[slot, :n_pages] = pages
        return sp

    def evict(self, slot: int) -> None:
        sp = self._slots[slot]
        if sp is None:
            raise PagePoolError(f"evict of empty slot {slot}")
        # reverse order: pages return LIFO, so the free list hands the
        # next admission the same pages back (fragmentation-free reuse)
        self.pool.free(reversed(sp.pages))
        self._slots[slot] = None
        null = self.pool.null_page if self.pool.null_page is not None \
            else NULL_PAGE
        self.table[slot, :] = null

    def slot(self, i: int) -> SlotPages | None:
        return self._slots[i]

    def occupied(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]
