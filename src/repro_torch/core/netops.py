"""Network primitives: the SIM backend of the runtime (port of the SIM
side of `repro/core/netops.py`).

One device carries N PEs: every array has a leading PE axis, and a
``ppermute`` edge (the analogue of an Epiphany memory-mapped remote store)
is a row gather on that axis.  On the card each ppermute is ONE launch of
the put_copy kernel (`kernels/put_copy.py`) driven by the pattern's
cached source-row table; on the CPU it is the kernel's plain version.

  * ``SimNetOps``    — the oracle: one row gather per ppermute.
  * ``NocSimNetOps`` — congestion-faithful: one gather row per
    link-disjoint WAVE of the pattern, folded with the k-ary combine
    kernel, so the work scales with the hottest link's multiplicity while
    the result stays bit-identical to ``SimNetOps``.

The SPMD backend (one PE per device over torch.distributed) is not
ported yet.  PE ids and patterns are static host data; every index table
is built on the host once and cached on the device.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from .. import resolve_device
from ..kernels import put_copy as _pc
from ..kernels import reduce_combine as _rc
from .heap import tree_flatten, tree_unflatten
from .pattern import CommPattern, PatternLike, as_pattern, intern_get


def tree_map(fn, *trees):
    """`fn` over the leaves of trees of one structure (dicts, lists,
    tuples of tensors)."""
    leaves, treedef = tree_flatten(trees[0])
    rest = [tree_flatten(t)[0] for t in trees[1:]]
    return tree_unflatten(treedef, [fn(*ls) for ls in zip(leaves, *rest)])


_TABLE_LOCK = threading.Lock()
_TABLES: dict = {}


def device_table(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array (a mask, an index table) as a tensor on `device`,
    uploaded once per (contents, device) and shared afterwards."""
    arr = np.ascontiguousarray(arr)
    key = (arr.tobytes(), arr.dtype.str, arr.shape, device)
    return intern_get(_TABLES, _TABLE_LOCK, 4096, key,
                      lambda: torch.as_tensor(arr.copy(), device=device))


def _mask_of(pe_mask) -> np.ndarray:
    """A select mask may be given as a host bool array or as a compiled
    CommPattern (meaning: its destination set)."""
    if isinstance(pe_mask, CommPattern):
        return pe_mask.dst_mask
    return np.asarray(pe_mask, dtype=bool)


class NetOps:
    """Protocol: n_pes, device, my_pe(), ppermute(), select(), with
    sender-driven semantics."""

    n_pes: int
    device: torch.device
    # Optional attached repro_torch.core.profile.Profiler (ShmemContext
    # sets it): ppermute traffic lands in its aggregate counters.  Plain
    # class attribute, NOT a dataclass field — the hot path pays one
    # `is None` test when unattached.
    profile = None

    def my_pe(self):
        raise NotImplementedError

    def _count_ppermute(self, p: CommPattern, x) -> None:
        """Aggregate-counter hook (near-zero when no profiler attached)."""
        prof = self.profile
        if prof is not None and prof.enabled:
            nbytes = float(sum(l.numel() * l.element_size()
                               for l in tree_flatten(x)[0]))
            prof.count(f"ppermute[n{p.n_pes},e{len(p.pairs)}]", 1, nbytes)

    def ppermute(self, x, perm: PatternLike):
        """Static point-to-point pattern: for each (src, dst) pair, dst
        receives src's shard; PEs not named as a dst receive zeros.
        `perm` is a raw (src, dst) pair list or a compiled
        :class:`~repro_torch.core.pattern.CommPattern` (preferred on hot
        paths — compiled once, reused every call).

        This is the 'remote store' primitive: it never blocks the sender,
        which is why a shmem *get* on this substrate is the paper's
        IPI-get — the owner pushes (DESIGN.md §2)."""
        raise NotImplementedError

    def select(self, pe_mask, a, b):
        """Per-PE static selection: where PE's entry in `pe_mask` (a host
        bool array indexed by pe id, or a CommPattern standing for its
        destination set) is True take `a` else `b`."""
        raise NotImplementedError


@dataclasses.dataclass
class SimNetOps(NetOps):
    """Single-device simulation: every array carries a leading PE axis.
    `device` defaults to the CUDA card (`repro_torch.resolve_device`)."""

    n_pes: int
    device: torch.device | str | None = None

    def __post_init__(self):
        dev = resolve_device(self.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev

    def my_pe(self):
        return torch.arange(self.n_pes, dtype=torch.int32,
                            device=self.device)

    def check(self, v: torch.Tensor) -> None:
        """Raise unless `v` is PE-stacked for this net, on its device."""
        if v.device != self.device:
            raise ValueError(f"tensor on {v.device}, the {self.n_pes}-PE "
                             f"net runs on {self.device}")
        if v.dim() == 0 or v.shape[0] != self.n_pes:
            raise ValueError(f"tensor of shape {tuple(v.shape)} has no "
                             f"leading axis of {self.n_pes} PEs")

    def ppermute(self, x, perm):
        p = as_pattern(perm, self.n_pes)
        if self.profile is not None:
            self._count_ppermute(p, x)
        table = p.gather_table_device(self.device)

        def one(v):
            self.check(v)
            return _pc.put_copy(v, table)

        return tree_map(one, x)

    def select(self, pe_mask, a, b):
        m = device_table(_mask_of(pe_mask), self.device)

        def one(x, y):
            self.check(x)
            self.check(y)
            return torch.where(m.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)

        return tree_map(one, a, b)


@dataclasses.dataclass
class NocSimNetOps(SimNetOps):
    """Congestion-faithful simulation: a ppermute moves one gather row per
    link-disjoint WAVE of its pattern (``CommPattern.link_waves``) — the
    flows a real NoC could fly concurrently share a wave, contending
    flows land in later waves, the way the eMesh serializes transmissions
    through a shared physical link.  Results are bit-identical to
    :class:`SimNetOps` (destinations are disjoint across waves,
    non-destinations receive zeros), but the bytes moved scale with the
    pattern's hot-link multiplicity.

    All waves run as ONE stacked put (W x n_pes output rows), then one
    W-ary sum (the combine kernel) folds the wave axis; at most one wave
    holds a PE's payload, so the fold is exact in every dtype (bool folds
    as uint8)."""

    topo: object = None
    _stack_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                           compare=False)

    def _wave_table(self, p: CommPattern):
        got = self._stack_cache.get(p)
        if got is None:
            waves = p.link_waves(self.topo)
            table = np.concatenate([w.src_for_dst for w in waves])
            got = (len(waves), torch.as_tensor(table.astype(np.int32),
                                               device=self.device))
            self._stack_cache[p] = got
        return got

    def ppermute(self, x, perm):
        p = as_pattern(perm, self.n_pes)
        if not p.pairs:                  # empty pattern: zeros, like base
            return super().ppermute(x, p)
        if self.profile is not None:
            self._count_ppermute(p, x)
        n_waves, table = self._wave_table(p)

        def one(v):
            self.check(v)
            stacked = _pc.put_copy(v, table)             # (W*n_pes, ...)
            if n_waves == 1:
                return stacked
            waves = stacked.reshape((n_waves, self.n_pes)
                                    + tuple(v.shape[1:])).unbind(0)
            if v.dtype == torch.bool:
                return _rc.reduce_combine(
                    [w.view(torch.uint8) for w in waves], "sum"
                ).view(torch.bool)
            return _rc.reduce_combine(waves, "sum")

        return tree_map(one, x)


# -- per-PE dynamic slicing helpers ------------------------------------------

def _block_index(net: SimNetOps, x, block_index, block_size: int, ax: int):
    """(n_pes, ...) gather index of each PE's block along dim `ax` of the
    stacked x; starts are clamped into range, as the reference's
    dynamic_slice clamps them."""
    if not isinstance(net, SimNetOps):
        raise NotImplementedError("only the SIM backend is ported")
    net.check(x)
    starts = torch.as_tensor(block_index, device=x.device).long() \
        .reshape(-1) * block_size
    starts = starts.clamp(0, max(x.shape[ax] - block_size, 0))
    idx = starts[:, None] + torch.arange(block_size, device=x.device)
    shape = [net.n_pes] + [1] * (x.dim() - 1)
    shape[ax] = block_size
    sizes = list(x.shape)
    sizes[ax] = block_size
    return idx.reshape(shape).expand(sizes)


def dyn_slice_block(net: NetOps, x, block_index, block_size: int, axis: int):
    """Each PE's ``v[..., block_index[pe]*block_size : +block_size, ...]``
    along `axis` of its (per-PE) array; `block_index` holds one index per
    PE."""
    idx = _block_index(net, x, block_index, block_size, axis + 1)
    return torch.gather(x, axis + 1, idx)


def dyn_update_block(net: NetOps, x, update, block_index, block_size: int,
                     axis: int):
    """`x` with each PE's block (as in `dyn_slice_block`) replaced by that
    PE's `update`."""
    idx = _block_index(net, x, block_index, block_size, axis + 1)
    return x.scatter(axis + 1, idx, update)
