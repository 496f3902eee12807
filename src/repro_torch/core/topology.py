"""2D/3D processing-element topology, after the Epiphany eMesh.

The paper's collectives are hop-count aware: the farthest-first broadcast
tree explicitly moves data the greatest mesh distance first so later stages
do not add congestion (paper §3.6).  On TPU the ICI torus plays the NoC
role; this module provides the PE <-> coordinate maps and hop metrics the
algorithms and the alpha-beta cost model use.

Unlike eLib's 2D row/column indexing (which the paper criticizes for not
addressing "arbitrary numbers of working cores or disabled cores"), PEs
here are a dense 0..N-1 rank space with an explicit active-set mapping, so
subsets and non-power-of-two groups are first-class.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """A d-dimensional mesh/torus of PEs.

    shape  : extent per dimension, e.g. (4, 4) for Epiphany-III,
             (16, 16) for one v5e pod, (2, 16, 16) for two pods.
    torus  : whether each dimension wraps (ICI axes do; the Epiphany
             eMesh does not).
    link_cost : relative per-hop cost multiplier per dimension (the "pod"
             axis rides DCN, ~10x an ICI hop).
    """

    shape: tuple[int, ...]
    torus: tuple[bool, ...] | None = None
    link_cost: tuple[float, ...] | None = None

    def __post_init__(self):
        if not self.shape or any(int(e) < 1 for e in self.shape):
            raise ValueError(
                f"mesh shape needs >=1 dimension with every extent >= 1, "
                f"got shape={self.shape!r}")
        if self.torus is not None and len(self.torus) != len(self.shape):
            raise ValueError(
                f"torus must name every dimension of shape: "
                f"len(torus)={len(self.torus)} vs len(shape)="
                f"{len(self.shape)} (a short tuple would silently "
                f"mis-price hops via zip truncation)")
        if (self.link_cost is not None
                and len(self.link_cost) != len(self.shape)):
            raise ValueError(
                f"link_cost must name every dimension of shape: "
                f"len(link_cost)={len(self.link_cost)} vs len(shape)="
                f"{len(self.shape)} (a short tuple would silently "
                f"mis-price hops via zip truncation)")

    @property
    def n_pes(self) -> int:
        return math.prod(self.shape)

    def _torus(self) -> tuple[bool, ...]:
        return self.torus if self.torus is not None else tuple(True for _ in self.shape)

    def _cost(self) -> tuple[float, ...]:
        return self.link_cost if self.link_cost is not None else tuple(1.0 for _ in self.shape)

    def coords(self, pe: int) -> tuple[int, ...]:
        """Row-major rank -> coordinate (last dim fastest)."""
        out = []
        for extent in reversed(self.shape):
            out.append(pe % extent)
            pe //= extent
        return tuple(reversed(out))

    def rank(self, coords: Sequence[int]) -> int:
        pe = 0
        for c, extent in zip(coords, self.shape):
            pe = pe * extent + (c % extent)
        return pe

    def hops(self, a: int, b: int) -> float:
        """Weighted hop distance between two PEs (X-then-Y dimension-ordered
        routing, like the eMesh)."""
        ca, cb = self.coords(a), self.coords(b)
        total = 0.0
        for x, y, extent, wrap, cost in zip(ca, cb, self.shape, self._torus(), self._cost()):
            d = abs(x - y)
            if wrap:
                d = min(d, extent - d)
            total += d * cost
        return total

    def max_hops(self) -> float:
        total = 0.0
        for extent, wrap, cost in zip(self.shape, self._torus(), self._cost()):
            d = extent - 1
            if wrap:
                d = extent // 2
            total += d * cost
        return total

    def farthest_first(self, root: int, pes: Sequence[int]) -> list[int]:
        """Order `pes` by decreasing hop distance from `root` (paper §3.6:
        'moving the data the farthest distance first')."""
        return sorted(pes, key=lambda p: (-self.hops(root, p), p))

    # -- XY routing (the eMesh's dimension-ordered wormhole path) ------------
    def route(self, a: int, b: int) -> tuple[tuple[int, int], ...]:
        """The directed link sequence a packet from `a` to `b` traverses
        under dimension-ordered routing: the LAST dimension is corrected
        first (the eMesh routes east/west along the row to the target
        column, then north/south — 'X then Y'), each dimension taking the
        shorter way around when it wraps (ties break toward +).  Every
        element is a (pe, neighbor_pe) hop; ``sum(link_weight(u, v))``
        over the route equals ``hops(a, b)``.  Cached per (topo, a, b)."""
        return _route(self, int(a) % self.n_pes, int(b) % self.n_pes)

    def route_alt(self, a: int, b: int) -> tuple[tuple[int, int], ...]:
        """The ALTERNATE dimension-ordered route: the FIRST dimension is
        corrected first ('Y then X' on a 2D mesh) — the other member of
        the minimal XY/YX route pair.  Same hop count as :meth:`route`
        but (off the source row/column) link-disjoint from it, which is
        what the fault layer retries over when a link on the primary
        route is down (DESIGN.md §17).  Cached per (topo, a, b)."""
        return _route_alt(self, int(a) % self.n_pes, int(b) % self.n_pes)

    def link_weight(self, u: int, v: int) -> float:
        """Per-hop cost of the (u, v) mesh link — the ``link_cost`` of the
        one dimension in which neighbors u and v differ."""
        cu, cv = self.coords(u), self.coords(v)
        for dim, (x, y) in enumerate(zip(cu, cv)):
            if x != y:
                return self._cost()[dim]
        return self._cost()[-1]      # self-link (degenerate 1-PE dims)

    # -- Hamiltonian embeddings (mesh-embedded rings) ------------------------
    def snake_order(self) -> tuple[int, ...]:
        """A Hamiltonian ordering of the PEs in which consecutive PEs are
        mesh NEIGHBORS — the embedding that turns every logical-ring hop
        into one physical hop (the boustrophedon 'snake').

        Where a Hamiltonian *cycle* exists (2D with an even extent, or a
        wrapping dimension that closes the path) the order is a cycle:
        the wrap edge ``order[-1] -> order[0]`` is also a single hop, so
        an offset-1 ring over the order touches every physical link at
        most once (``max_link_load == 1``).  On odd-by-odd non-torus
        meshes no cycle exists (bipartite, odd vertex count) and the
        boustrophedon path is returned — all interior edges one hop, only
        the wrap edge longer.  Candidates are scored by the ring's actual
        link loads under :meth:`route`, so the least-congested embedding
        wins."""
        return _snake(self)


@functools.lru_cache(maxsize=1 << 16)
def _route(topo: MeshTopology, a: int, b: int) -> tuple[tuple[int, int], ...]:
    return _dim_ordered(topo, a, b, reversed(range(len(topo.shape))))


@functools.lru_cache(maxsize=1 << 16)
def _route_alt(topo: MeshTopology, a: int, b: int
               ) -> tuple[tuple[int, int], ...]:
    return _dim_ordered(topo, a, b, range(len(topo.shape)))


def _dim_ordered(topo: MeshTopology, a: int, b: int, dims
                 ) -> tuple[tuple[int, int], ...]:
    ca = list(topo.coords(a))
    cb = topo.coords(b)
    links: list[tuple[int, int]] = []
    for dim in dims:
        extent = topo.shape[dim]
        delta = cb[dim] - ca[dim]
        if topo._torus()[dim]:
            fwd = delta % extent
            back = (-delta) % extent
            step, count = (1, fwd) if fwd <= back else (-1, back)
        else:
            step, count = (1 if delta > 0 else -1), abs(delta)
        for _ in range(count):
            nxt = list(ca)
            nxt[dim] = (ca[dim] + step) % extent
            links.append((topo.rank(ca), topo.rank(nxt)))
            ca = nxt
    return tuple(links)


def _boustrophedon(shape: tuple[int, ...]) -> list[tuple[int, ...]]:
    """Recursive snake: dimension 0 indexes copies of the inner snake,
    alternating direction so consecutive coordinates stay adjacent."""
    if len(shape) == 1:
        return [(i,) for i in range(shape[0])]
    inner = _boustrophedon(shape[1:])
    out: list[tuple[int, ...]] = []
    for i in range(shape[0]):
        seq = inner if i % 2 == 0 else inner[::-1]
        out.extend((i,) + c for c in seq)
    return out


def _spine_cycle(R: int, C: int) -> list[tuple[int, int]] | None:
    """The classic grid Hamiltonian cycle (R even, R,C >= 2): east along
    row 0, boustrophedon over rows 1..R-1 restricted to cols 1..C-1, then
    north up the col-0 'spine' back to the start."""
    if R < 2 or C < 2 or R % 2:
        return None
    order = [(0, c) for c in range(C)]
    for i, r in enumerate(range(1, R)):
        cols = range(C - 1, 0, -1) if i % 2 == 0 else range(1, C)
        order.extend((r, c) for c in cols)
    order.extend((r, 0) for r in range(R - 1, 0, -1))
    return order


@functools.lru_cache(maxsize=256)
def _snake(topo: MeshTopology) -> tuple[int, ...]:
    candidates: list[list[tuple[int, ...]]] = [_boustrophedon(topo.shape)]
    if len(topo.shape) == 2:
        R, C = topo.shape
        cyc = _spine_cycle(R, C)
        if cyc is not None:
            candidates.append(cyc)
        cyc_t = _spine_cycle(C, R)
        if cyc_t is not None:
            candidates.append([(r, c) for c, r in cyc_t])

    def score(order: list[tuple[int, ...]]):
        pes = [topo.rank(c) for c in order]
        loads: dict[tuple[int, int], float] = {}
        worst_edge = 0.0
        for i, pe in enumerate(pes):
            dst = pes[(i + 1) % len(pes)]
            if dst == pe:
                continue
            worst_edge = max(worst_edge, topo.hops(pe, dst))
            for u, v in topo.route(pe, dst):
                key = (u, v) if u < v else (v, u)
                loads[key] = loads.get(key, 0.0) + 1.0   # flow multiplicity
        return (max(loads.values()) if loads else 0.0, worst_edge)

    best = min(candidates, key=score)
    return tuple(topo.rank(c) for c in best)


def epiphany3() -> MeshTopology:
    """The paper's chip: 4x4 mesh, no wraparound."""
    return MeshTopology(shape=(4, 4), torus=(False, False))


def v5e_pod() -> MeshTopology:
    """One 256-chip pod: 16x16 ICI torus."""
    return MeshTopology(shape=(16, 16))


def v5e_multipod(pods: int = 2) -> MeshTopology:
    """`pods` pods linked over DCN: DCN hop ~10x an ICI hop."""
    return MeshTopology(
        shape=(pods, 16, 16),
        torus=(False, True, True),
        link_cost=(10.0, 1.0, 1.0),
    )
