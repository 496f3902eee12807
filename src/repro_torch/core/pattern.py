"""Compiled communication patterns — the precomputed-schedule layer.

The paper's PEs precompute their neighbor lists and remote addresses in
``shmem_init`` so the hot path is a bare memory-mapped store; the
analogue here is compiling a static ``(src, dst)`` pattern ONCE into a
:class:`CommPattern` carrying everything every consumer used to rebuild
per call (DESIGN.md §9):

  * the forward pair list,
  * the inverse pattern (gets and atomic fetches run the reverse edges),
  * destination/source masks (what ``select`` wants) and the source-row
    table of the put kernel, cached per device,
  * per-pair weighted hop counts against an attached
    :class:`~repro_torch.core.topology.MeshTopology` (what the
    alpha-beta cost model wants).

Patterns are interned per ``(pairs, n_pes)``: compiling the same pattern
twice returns the *same object*, so repeated collective stages and the
put/get/atomic call sites share one compilation, and inverse round-trips
are identity-stable (``p.inverse.inverse is p``).

:class:`Schedule` stacks compiled patterns into the multi-stage plans the
collectives execute; each :class:`Stage` carries its payload bytes so the
``(bytes, hops, max_link_load)`` cost descriptor is derived from the very
object that runs — there is no hand-maintained parallel cost function to
drift.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Sequence, Union

import numpy as np
import torch

from .topology import MeshTopology

Pairs = Sequence[tuple[int, int]]
PatternLike = Union["CommPattern", Pairs]

_INTERN_LOCK = threading.Lock()
_INTERN: dict[tuple[tuple[tuple[int, int], ...], int], "CommPattern"] = {}
# Interning is a cache, not a registry: a job issuing data-dependent
# ad-hoc patterns (one per step) must not pin them all for the process
# lifetime.  Beyond the cap the oldest entries are dropped — they keep
# working, they just stop being shared/identity-stable.  The canonical
# collective families (ring/xor/binomial per n_pes) number far below this.
_INTERN_MAX = 4096


class CommPattern:
    """A static point-to-point pattern compiled for a fixed PE count.

    Never construct directly — go through :func:`compile_pattern` (or
    :func:`as_pattern`) so instances are interned and compile-once caching
    holds.  Instances are immutable and hash/compare by identity.
    """

    __slots__ = (
        "pairs", "n_pes", "dst_mask", "src_mask", "src_for_dst",
        "_inverse", "_hops_cache", "_table_cache", "_link_cache",
        "_wave_cache",
    )

    def __init__(self, pairs: tuple[tuple[int, int], ...], n_pes: int,
                 _token=None):
        if _token is not _COMPILE_TOKEN:
            raise TypeError("use compile_pattern()/as_pattern(), not "
                            "CommPattern(...) — patterns are interned")
        self.pairs = pairs
        self.n_pes = n_pes
        src_for_dst = np.full((n_pes,), -1, dtype=np.int64)
        src_mask = np.zeros((n_pes,), dtype=bool)
        dst_mask = np.zeros((n_pes,), dtype=bool)
        for s, d in pairs:
            src_for_dst[d] = s
            src_mask[s] = True
            dst_mask[d] = True
        src_for_dst.setflags(write=False)
        src_mask.setflags(write=False)
        dst_mask.setflags(write=False)
        self.src_for_dst = src_for_dst
        self.src_mask = src_mask
        self.dst_mask = dst_mask
        self._inverse: CommPattern | None = None
        self._hops_cache: dict[MeshTopology, np.ndarray] = {}
        self._table_cache: dict = {}
        self._link_cache: dict = {}
        self._wave_cache: dict = {}

    # -- structure ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.pairs)

    def __iter__(self):
        return iter(self.pairs)

    def __repr__(self) -> str:
        shown = list(self.pairs[:4])
        more = f", +{len(self.pairs) - 4} more" if len(self.pairs) > 4 else ""
        return f"CommPattern(n_pes={self.n_pes}, pairs={shown}{more})"

    @property
    def inverse(self) -> "CommPattern":
        """The reversed-edge pattern (dst, src) — what a get or an atomic
        fetch runs.  Interned, so ``p.inverse.inverse is p``."""
        if self._inverse is None:
            inv = compile_pattern([(d, s) for s, d in self.pairs], self.n_pes)
            self._inverse = inv
            if inv._inverse is None:
                inv._inverse = self
        return self._inverse

    # -- device-ready tables -------------------------------------------------
    def gather_table_device(self, device) -> torch.Tensor:
        """``src_for_dst`` as an int32 tensor on `device` (row ``d`` of a
        delivery comes from row ``table[d]``; -1 means no source: zeros):
        the source-row table of the put kernel that every SIM ppermute
        launches.  Built once per (pattern, device) from the host array,
        so the hot path never re-uploads indices."""
        device = torch.device(device)
        got = self._table_cache.get(device)
        if got is None:
            got = torch.as_tensor(self.src_for_dst.astype(np.int32),
                                  device=device)
            self._table_cache[device] = got
        return got

    def relabel(self, ranks: Sequence[int], n_pes: int) -> "CommPattern":
        """Map this pattern's PE ids through `ranks` (index -> new PE id)
        and compile for `n_pes` — the team-coordinate -> world-coordinate
        lift (DESIGN.md §11).  Interned like every compiled pattern, so a
        team-relative schedule lifts to the same world objects every call."""
        return compile_pattern(
            [(ranks[s], ranks[d]) for s, d in self.pairs], n_pes)

    # -- topology-derived cost metadata --------------------------------------
    def pair_hops(self, topo: MeshTopology | None) -> np.ndarray:
        """Weighted hop distance of every (src, dst) edge under `topo`
        (1.0 per edge when no topology is attached)."""
        if topo is None:
            return np.ones((len(self.pairs),), dtype=np.float64)
        cached = self._hops_cache.get(topo)
        if cached is None:
            cached = np.array([topo.hops(s, d) for s, d in self.pairs],
                              dtype=np.float64)
            cached.setflags(write=False)
            self._hops_cache[topo] = cached
        return cached

    def max_hops(self, topo: MeshTopology | None) -> float:
        """Worst-path hop count — the stage latency term under
        dimension-ordered routing with no congestion (all edges of a stage
        fly concurrently; the stage completes when the longest one lands)."""
        h = self.pair_hops(topo)
        return float(h.max()) if len(h) else 0.0

    def total_hops(self, topo: MeshTopology | None) -> float:
        """Sum of edge hop counts — the stage's aggregate link occupancy
        (the congestion/energy term, not the latency term)."""
        return float(self.pair_hops(topo).sum())

    def link_loads(self, topo) -> dict[tuple[int, int], float]:
        """Per-physical-link FLOW MULTIPLICITY of this pattern under the
        topology's dimension-ordered routing (``topo.route``) — how many
        flows cross each link, unweighted (per-dimension link costs stay
        in the hop/latency term; weighting loads too would double-price
        slow links, and multiplicity is what ``link_waves`` serializes).

        Keys are canonical undirected links ``(min_pe, max_pe)``: the two
        directions of a mesh link share router switching/arbitration, so
        counter-flows contend — the conservative model, and the one under
        which the paper's farthest-first ordering and the snake embedding
        are visible on small meshes (a purely directed count calls the
        4x4 logical ring congestion-free).  Cached per (pattern, topo)
        like the hop caches; the returned dict is shared — don't mutate."""
        cached = self._link_cache.get(topo)
        if cached is None:
            loads: dict[tuple[int, int], float] = {}
            for s, d in self.pairs:
                if s == d:
                    continue
                for u, v in topo.route(s, d):
                    key = (u, v) if u < v else (v, u)
                    loads[key] = loads.get(key, 0.0) + 1.0
            cached = loads
            self._link_cache[topo] = cached
        return cached

    def max_link_load(self, topo) -> float:
        """The congestion metric: flow multiplicity through the hottest
        physical link — the factor by which the stage's payload serializes
        there.  1.0 with no topology (flat network: every pair its own
        link) or when every routed link carries a single flow."""
        if topo is None:
            return 1.0 if self.pairs else 0.0
        loads = self.link_loads(topo)
        return max(loads.values()) if loads else (1.0 if self.pairs else 0.0)

    def link_waves(self, topo) -> tuple["CommPattern", ...]:
        """The pairs split greedily into sub-patterns whose routes are
        link-disjoint.  A congestion-faithful executor (netops.NocSimNetOps)
        runs one wave at a time — the flows a real NoC could fly
        concurrently — so measured wall time scales with contention the
        way ``max_link_load`` prices it.  Destinations are disjoint across
        waves (unique per pattern), so wave results combine losslessly.
        Cached per (pattern, topo); single wave == no contention."""
        cached = self._wave_cache.get(topo)
        if cached is None:
            waves: list[list[tuple[int, int]]] = []
            used: list[set[tuple[int, int]]] = []
            # farthest-first (paper §3.6): packing the longest routes
            # first keeps the greedy coloring at (or near) the hot-link
            # load bound instead of fragmenting long flows across waves
            order = self.pairs if topo is None else sorted(
                self.pairs, key=lambda p: -topo.hops(p[0], p[1]))
            for s, d in order:
                links = {(u, v) if u < v else (v, u)
                         for u, v in (topo.route(s, d) if topo is not None
                                      else ())}
                for w, u in zip(waves, used):
                    if not (links & u):
                        w.append((s, d))
                        u |= links
                        break
                else:
                    waves.append([(s, d)])
                    used.append(set(links))
            cached = tuple(compile_pattern(w, self.n_pes) for w in waves)
            self._wave_cache[topo] = cached
        return cached


_COMPILE_TOKEN = object()


def _normalize(pattern: Pairs, n_pes: int) -> tuple[tuple[int, int], ...]:
    pairs = tuple(sorted((int(s) % n_pes, int(d) % n_pes)
                         for s, d in pattern))
    dsts = [d for _, d in pairs]
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"pattern names a destination twice: {pairs}")
    return pairs


def intern_get(table: dict, lock: threading.Lock, cap: int, key, build):
    """Shared intern-with-cap: double-checked lookup, FIFO eviction past
    `cap`.  One copy of the concurrency-sensitive machinery for every
    interned family (patterns here, teams in core/team.py)."""
    got = table.get(key)
    if got is None:
        with lock:
            got = table.get(key)
            if got is None:
                got = build()
                while len(table) >= cap:
                    table.pop(next(iter(table)))
                table[key] = got
    return got


def compile_pattern(pattern: Pairs, n_pes: int) -> CommPattern:
    """Compile (and intern) a static (src, dst) pattern for `n_pes` PEs.

    Pairs are taken mod n_pes and canonically sorted, so two call sites
    listing the same edges in different orders share one compiled object.
    """
    if isinstance(pattern, CommPattern):
        if pattern.n_pes != n_pes:
            raise ValueError(
                f"pattern compiled for {pattern.n_pes} PEs used with {n_pes}")
        return pattern
    key = (_normalize(pattern, n_pes), n_pes)
    return intern_get(
        _INTERN, _INTERN_LOCK, _INTERN_MAX, key,
        lambda: CommPattern(key[0], n_pes, _token=_COMPILE_TOKEN))


def as_pattern(pattern: PatternLike, n_pes: int) -> CommPattern:
    """Coerce a raw pair list or an already-compiled pattern."""
    return compile_pattern(pattern, n_pes)


def cache_size() -> int:
    return len(_INTERN)


# -- canonical pattern families (the collectives' vocabulary) ----------------

def ring_pattern(n: int, offset: int = 1) -> CommPattern:
    """Every PE sends to (pe + offset) mod n — one ring/pairwise stage."""
    return compile_pattern([(i, (i + offset) % n) for i in range(n)], n)


def xor_pattern(n: int, stride: int) -> CommPattern:
    """Recursive-doubling exchange: i <-> i ^ stride (n a power of two)."""
    return compile_pattern([(i, i ^ stride) for i in range(n)], n)


def binomial_stage_pattern(n: int, stride: int, root: int = 0) -> CommPattern:
    """One farthest-first binomial broadcast stage: subtree roots at
    relative rank multiples of 2*stride push to rank+stride (paper §3.6)."""
    pairs = []
    for rel in range(0, n, 2 * stride):
        rel_dst = rel + stride
        if rel_dst < n:
            pairs.append(((rel + root) % n, (rel_dst + root) % n))
    return compile_pattern(pairs, n)


# -- schedules ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Stage:
    """One serialized step of a collective: a compiled pattern plus the
    per-edge payload it moves."""

    pattern: CommPattern
    nbytes: float

    def cost(self, topo: MeshTopology | None = None
             ) -> tuple[float, float, float]:
        """(bytes, hops, max_link_load) — the alpha-beta model's stage
        descriptor: worst-path latency AND hottest-link serialization
        (``abmodel.LinkModel.time`` prices all three terms)."""
        return (float(self.nbytes), self.pattern.max_hops(topo),
                self.pattern.max_link_load(topo))


@dataclasses.dataclass(frozen=True)
class Schedule:
    """An ordered list of stages; what a collective algorithm *is*.

    The same object both drives execution (consumers iterate `stages` and
    ppermute each `stage.pattern`) and prices itself for the cost model —
    so predicted and executed schedules cannot diverge.
    """

    name: str
    stages: tuple[Stage, ...]

    def __len__(self) -> int:
        return len(self.stages)

    def __iter__(self) -> Iterable[Stage]:
        return iter(self.stages)

    def cost(self, topo: MeshTopology | None = None
             ) -> list[tuple[float, float, float]]:
        """[(bytes, hops, max_link_load)] per stage — feed to
        `abmodel.modeled_collective_time`."""
        return [st.cost(topo) for st in self.stages]

    def time(self, topo: MeshTopology | None = None, link=None) -> float:
        """Alpha-beta modeled wall time of the whole schedule."""
        from . import abmodel
        link = link if link is not None else abmodel.ICI_V5E
        return abmodel.modeled_collective_time(self.cost(topo), link)

    def pipelined_time(self, n_chunks: int,
                       topo: MeshTopology | None = None, link=None) -> float:
        """Modeled wall time when executed chunked/double-buffered in
        `n_chunks` pieces (stage k of chunk i overlapping stage k+1 of
        chunk i-1); n_chunks=1 is the monolithic time."""
        from . import abmodel
        link = link if link is not None else abmodel.ICI_V5E
        return abmodel.modeled_pipelined_time(self.cost(topo), n_chunks, link)

    def total_bytes(self) -> float:
        return sum(st.nbytes for st in self.stages)
