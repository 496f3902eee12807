"""Symmetric heap: the paper's §3.2 brk/sbrk bump allocator.

Rules enforced exactly as in the paper:
  1. free() must be called in reverse order of allocation when followed by
     further allocations (we check and raise);
  2. realloc() only on the most recent (re)allocation;
  3. alignment must be a power of two >= 8 (default 8).

There is no virtual-address abstraction: an allocation *is* an offset into
one flat symmetric buffer, identical on every PE.  The serving engine's KV
pages are such offsets (serve/kv.py).
"""
from __future__ import annotations

import dataclasses


class HeapError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Allocation:
    offset: int
    size: int          # requested bytes
    seq: int           # allocation sequence number


class SymmetricHeap:
    """Host-side symmetric-heap bookkeeping."""

    def __init__(self, capacity: int, default_align: int = 8):
        if default_align < 8 or default_align & (default_align - 1):
            raise HeapError("default alignment must be a power of 2 >= 8")
        self.capacity = capacity
        self.default_align = default_align
        self._brk = 0           # local base memory tracking pointer
        self._live: list[Allocation] = []
        self._seq = 0

    @property
    def brk(self) -> int:
        return self._brk

    def sbrk(self, nbytes: int) -> int:
        """Move the break; returns previous break (like Unix sbrk)."""
        if self._brk + nbytes > self.capacity:
            raise HeapError(
                f"heap exhausted: brk={self._brk} + {nbytes} > {self.capacity}")
        prev = self._brk
        self._brk += nbytes
        return prev

    def malloc(self, nbytes: int, align: int | None = None) -> Allocation:
        align = align or self.default_align
        if align < 8 or align & (align - 1):
            raise HeapError("alignment must be a power of 2 >= 8")
        base = -(-self._brk // align) * align
        self.sbrk((base - self._brk) + nbytes)
        a = Allocation(offset=base, size=nbytes, seq=self._seq)
        self._seq += 1
        self._live.append(a)
        return a

    def align_alloc(self, align: int, nbytes: int) -> Allocation:
        return self.malloc(nbytes, align=align)

    def free(self, alloc: Allocation) -> None:
        """Paper rule 1: moves brk back to alloc.offset, implicitly freeing
        everything allocated after it (so freeing the *first* of a series
        frees the series)."""
        if alloc not in self._live:
            raise HeapError("free of unknown or already-freed allocation")
        self._live = [a for a in self._live if a.seq < alloc.seq]
        self._brk = alloc.offset

    def realloc(self, alloc: Allocation, nbytes: int) -> Allocation:
        """Paper rule 2: only the last (re)allocation may be realloc'd.
        Contents are NOT copied (the paper declines to waste the space)."""
        if not self._live or self._live[-1].seq != alloc.seq:
            raise HeapError("realloc only valid on the last allocation")
        self._live.pop()
        self._brk = alloc.offset
        return self.malloc(nbytes)

    def live_bytes(self) -> int:
        return self._brk
