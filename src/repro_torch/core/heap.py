"""Symmetric heap: the paper's §3.2 brk/sbrk bump allocator, plus tree
packing onto one flat buffer (many small reductions fuse into one).

Rules enforced exactly as in the paper:
  1. free() must be called in reverse order of allocation when followed by
     further allocations (we check and raise);
  2. realloc() only on the most recent (re)allocation;
  3. alignment must be a power of two >= 8 (default 8).

There is no virtual-address abstraction: an allocation *is* an offset into
one flat symmetric buffer, identical on every PE.  The serving engine's KV
pages are such offsets (serve/kv.py).  `pack`/`unpack` lay a tree of
tensors (dicts, lists and tuples of them) out on such a buffer: the
alpha term of one large reduction is paid once, not per leaf — the
paper's small-message lesson.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch


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


# ---------------------------------------------------------------------------
# tree packing onto a symmetric flat buffer
# ---------------------------------------------------------------------------

def tree_flatten(tree) -> tuple[list, Any]:
    """Leaves of a tree of dicts (keys in sorted order, as JAX orders
    them), lists and tuples, and the structure to rebuild it."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [tree_flatten(tree[k]) for k in keys]
        return ([l for ls, _ in subs for l in ls],
                ("dict", tuple(keys), tuple(d for _, d in subs)))
    if isinstance(tree, (list, tuple)):
        subs = [tree_flatten(v) for v in tree]
        return ([l for ls, _ in subs for l in ls],
                (type(tree), None, tuple(d for _, d in subs)))
    return [tree], None


def _build(treedef, leaves) -> Any:
    if treedef is None:
        return next(leaves)
    kind, keys, subs = treedef
    vals = [_build(s, leaves) for s in subs]
    return dict(zip(keys, vals)) if kind == "dict" else kind(vals)


def tree_unflatten(treedef, leaves) -> Any:
    # a module-level recursion: a nested recursive closure would form a
    # reference cycle holding `leaves` (large tensors) until the cyclic
    # garbage collector ran
    return _build(treedef, iter(leaves))


@dataclasses.dataclass(frozen=True)
class PackSpec:
    treedef: Any
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    offsets: tuple[int, ...]     # element offsets in the flat buffer
    total: int                   # total elements (padded)
    dtype: torch.dtype           # buffer dtype


def plan_pack(tree, dtype=None, align_elems: int = 128) -> PackSpec:
    """Lay a tree out on a flat symmetric buffer; each leaf starts at a
    multiple of `align_elems` elements and the total is padded to one."""
    leaves, treedef = tree_flatten(tree)
    if dtype is None:
        dtype = functools.reduce(torch.promote_types,
                                 [l.dtype for l in leaves])
    shapes, dtypes, offsets = [], [], []
    off = 0
    for l in leaves:
        shapes.append(tuple(l.shape))
        dtypes.append(l.dtype)
        off = -(-off // align_elems) * align_elems
        offsets.append(off)
        off += math.prod(l.shape)
    total = -(-off // align_elems) * align_elems
    return PackSpec(treedef, tuple(shapes), tuple(dtypes), tuple(offsets),
                    total, dtype)


def pack(tree, spec: PackSpec) -> torch.Tensor:
    """The flat buffer of `tree` laid out by `spec`; gaps are zero."""
    leaves, _ = tree_flatten(tree)
    device = leaves[0].device if leaves else None
    buf = torch.zeros((spec.total,), dtype=spec.dtype, device=device)
    for l, off in zip(leaves, spec.offsets):
        flat = l.reshape(-1)
        buf[off:off + flat.numel()] = flat.to(spec.dtype)
    return buf


def unpack(buf: torch.Tensor, spec: PackSpec):
    """The tree `pack` laid out; a leaf whose dtype is the buffer's is a
    view of `buf`, not a copy."""
    leaves = []
    for shape, dt, off in zip(spec.shapes, spec.dtypes, spec.offsets):
        n = math.prod(shape)
        leaves.append(buf[off:off + n].reshape(shape).to(dt))
    return tree_unflatten(spec.treedef, leaves)
