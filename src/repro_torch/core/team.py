"""Teams and team partitions — structured PE grouping (OpenSHMEM 1.4+).

The paper targets OpenSHMEM 1.3, where every collective re-derives its
group from a raw ``(PE_start, logPE_stride, PE_size)`` active set.  The
follow-on Epiphany work (arXiv:1604.04205, arXiv:1704.08343) points at
structured PE grouping as the path to scaling beyond one 2D array; this
module is that layer (DESIGN.md §11):

  * :class:`Team` — an interned, immutable subset of the world PE space
    with rank translation both ways.  A team *is* a coordinate system:
    collective schedules are built in team coordinates (``team.size``
    ranks) once, then *lifted* to world coordinates through the team's
    member list (``Team.lift`` / ``CommPattern.relabel``) — compiled and
    cached per ``(team, pairs)``, interned like every pattern.
  * :class:`TeamPartition` — a disjoint cover of the world by equal-size
    teams (e.g. all rows of a mesh).  Its lift is the *union* of every
    member team's lift, so one world-level ``CommPattern`` runs all the
    teams' stage-k exchanges concurrently — what the hierarchical
    collectives execute.
  * :class:`TeamTopology` — a team-coordinate view of a world
    :class:`~repro_torch.core.topology.MeshTopology`: ``hops(a, b)`` prices
    team rank pairs at the world distance of the members they name, so
    the alpha-beta model can price un-lifted team-relative schedules.

Constructors mirror OpenSHMEM: :func:`team_world`,
:func:`split_strided` (``shmem_team_split_strided``), :func:`split_2d`
(row/column teams from a :class:`MeshTopology`), plus
:func:`from_active_set` — the 1.3 compatibility shim that makes a
``(PE_start, logPE_stride, PE_size)`` triple resolve to the same
interned team (and therefore the same compiled schedules) as the
explicit-team API.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np

from .pattern import (CommPattern, PatternLike, Schedule, Stage, as_pattern,
                      intern_get)
from .topology import MeshTopology

_INTERN_LOCK = threading.Lock()
_INTERN: dict[tuple[tuple[int, ...], int], "Team"] = {}
# Like pattern interning, a cache with a cap — the canonical families
# (world, rows, columns, active sets) number far below it.
_INTERN_MAX = 1024

_TOKEN = object()


class Team:
    """An immutable ordered subset of the world PE space.

    Never construct directly — go through :func:`make_team` (or the
    named constructors) so instances are interned: the same member list
    yields the *same object*, which keeps per-team schedule caches and
    hash-by-identity cheap.  ``members[r]`` is the world PE of team rank
    ``r``; ranks are dense ``0..size-1``.
    """

    __slots__ = ("members", "world_n", "rank_np", "member_np",
                 "_lift_cache", "_topo_cache")

    def __init__(self, members: tuple[int, ...], world_n: int, _token=None):
        if _token is not _TOKEN:
            raise TypeError("use make_team()/team_world()/split_*(), not "
                            "Team(...) — teams are interned")
        self.members = members
        self.world_n = world_n
        rank = np.full((world_n,), -1, dtype=np.int64)
        member = np.zeros((world_n,), dtype=bool)
        for r, pe in enumerate(members):
            rank[pe] = r
            member[pe] = True
        rank.setflags(write=False)
        member.setflags(write=False)
        self.rank_np = rank          # world pe -> team rank (-1 outside)
        self.member_np = member      # world pe -> in-team?
        self._lift_cache: dict[CommPattern, CommPattern] = {}
        self._topo_cache: dict[MeshTopology, TeamTopology] = {}

    # -- structure ----------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def covers_world(self) -> bool:
        return len(self.members) == self.world_n

    def __len__(self) -> int:
        return len(self.members)

    def __repr__(self) -> str:
        shown = list(self.members[:6])
        more = f", +{len(self.members) - 6} more" if len(self.members) > 6 else ""
        return f"Team(world_n={self.world_n}, members={shown}{more})"

    # -- translation (shmem_team_translate_pe) -------------------------------
    def translate(self, world_pe: int) -> int:
        """World PE -> team rank, or -1 when `world_pe` is not a member
        (including ids outside the world — no silent modulo wrap)."""
        pe = int(world_pe)
        if not 0 <= pe < self.world_n:
            return -1
        return int(self.rank_np[pe])

    def world_pe(self, team_rank: int) -> int:
        """Team rank -> world PE (the inverse of :meth:`translate`)."""
        return self.members[team_rank]

    # -- team-coordinate -> world-coordinate lifting -------------------------
    def lift(self, pattern: PatternLike) -> CommPattern:
        """Compile a team-coordinate ``(src, dst)`` pattern (ranks in
        ``0..size-1``) into the world-coordinate pattern that executes.
        Cached per (team, pairs): the same team schedule lifts to the
        same interned world objects on every call."""
        p = as_pattern(pattern, self.size)
        got = self._lift_cache.get(p)
        if got is None:
            got = p.relabel(self.members, self.world_n)
            self._lift_cache[p] = got
        return got

    def lift_schedule(self, sched: Schedule) -> Schedule:
        """Lift every stage of a team-coordinate Schedule; stage payloads
        are unchanged (bytes are per-member, not per-team)."""
        return Schedule(f"{sched.name}@team{self.size}", tuple(
            Stage(self.lift(st.pattern), st.nbytes) for st in sched.stages))

    # -- cost-model view ------------------------------------------------------
    def topo_view(self, world_topo: MeshTopology | None):
        """The team's slice of a world topology: a hop metric over team
        ranks, priced at the world distance of the members they name.
        Feed to ``Schedule.cost``/``.time`` to price an *un-lifted*
        team-relative schedule (lifted schedules price against the world
        topology directly and agree by construction)."""
        if world_topo is None:
            return None
        got = self._topo_cache.get(world_topo)
        if got is None:
            got = TeamTopology(self, world_topo)
            self._topo_cache[world_topo] = got
        return got


@dataclasses.dataclass(frozen=True, eq=False)
class TeamTopology:
    """Hop metric over team ranks — a Team's view of the world topology.
    Duck-types the ``hops(a, b)`` surface `CommPattern.pair_hops` and the
    alpha-beta model consume.  Hash/compare by identity (cached per
    (team, world) pair in ``Team.topo_view``)."""

    team: Team
    world: MeshTopology

    @property
    def n_pes(self) -> int:
        return self.team.size

    def hops(self, a: int, b: int) -> float:
        return self.world.hops(self.team.members[a], self.team.members[b])

    def route(self, a: int, b: int) -> tuple[tuple[int, int], ...]:
        """The WORLD route between the members team ranks a/b name — link
        endpoints are world PEs, so an un-lifted team schedule's link
        loads equal the lifted schedule's by construction."""
        return self.world.route(self.team.members[a], self.team.members[b])

    def link_weight(self, u: int, v: int) -> float:
        return self.world.link_weight(u, v)


def make_team(members: Sequence[int], world_n: int) -> Team:
    """Intern (and validate) a team from an explicit world-PE list."""
    mem = tuple(int(m) for m in members)
    if not mem:
        raise ValueError("a team needs at least one member")
    if any(m < 0 or m >= world_n for m in mem):
        raise ValueError(f"member out of range for world_n={world_n}: {mem}")
    if len(set(mem)) != len(mem):
        raise ValueError(f"duplicate members: {mem}")
    key = (mem, world_n)
    return intern_get(_INTERN, _INTERN_LOCK, _INTERN_MAX, key,
                      lambda: Team(mem, world_n, _token=_TOKEN))


def team_world(world_n: int) -> Team:
    """The predefined world team (SHMEM_TEAM_WORLD)."""
    return make_team(range(world_n), world_n)


def split_strided(parent: Team, start: int, stride: int, size: int) -> Team:
    """``shmem_team_split_strided``: ranks start, start+stride, ... of
    `parent` (parent-rank space, so splits compose)."""
    if size <= 0:
        raise ValueError("size must be positive")
    idx = [start + i * stride for i in range(size)]
    if any(i < 0 or i >= parent.size for i in idx):
        raise ValueError(
            f"strided split ({start},{stride},{size}) leaves parent "
            f"(size {parent.size})")
    return make_team([parent.members[i] for i in idx], parent.world_n)


def from_active_set(pe_start: int, log_pe_stride: int, pe_size: int,
                    world_n: int) -> Team:
    """The OpenSHMEM 1.3 active-set shim: ``(PE_start, logPE_stride,
    PE_size)`` resolves to the interned team the explicit API would
    build, so 1.3-style ``to_all`` calls emit the same compiled
    schedules (DESIGN.md §11)."""
    return split_strided(team_world(world_n), pe_start, 1 << log_pe_stride,
                         pe_size)


class TeamPartition:
    """A disjoint, equal-size team cover of a parent PE set.

    Execution view: every PE has a team and a rank within it, and
    :meth:`lift` unions the member teams' lifts of a team-coordinate
    pattern into ONE world pattern — all teams run their stage-k
    exchange concurrently.  This is what the hierarchical collectives
    and the team-relative ring algorithms execute
    (`collectives.allreduce_hier`).
    """

    __slots__ = ("teams", "world_n", "rank_np", "member_np", "team_id_np",
                 "_lift_cache", "_complement")

    def __init__(self, teams: Sequence[Team]):
        teams = tuple(teams)
        if not teams:
            raise ValueError("a partition needs at least one team")
        world_n = teams[0].world_n
        size = teams[0].size
        for t in teams:
            if t.world_n != world_n:
                raise ValueError("teams disagree on world_n")
            if t.size != size:
                raise ValueError(
                    f"partition teams must be equal size: {size} vs {t.size}")
        rank = np.full((world_n,), -1, dtype=np.int64)
        team_id = np.full((world_n,), -1, dtype=np.int64)
        member = np.zeros((world_n,), dtype=bool)
        for ti, t in enumerate(teams):
            for r, pe in enumerate(t.members):
                if member[pe]:
                    raise ValueError(f"PE {pe} appears in two teams")
                rank[pe], team_id[pe], member[pe] = r, ti, True
        for a in (rank, team_id, member):
            a.setflags(write=False)
        self.teams = teams
        self.world_n = world_n
        self.rank_np = rank
        self.member_np = member
        self.team_id_np = team_id
        self._lift_cache: dict[CommPattern, CommPattern] = {}
        self._complement: TeamPartition | None = None

    # -- structure ----------------------------------------------------------
    @property
    def size(self) -> int:
        """Per-team size (uniform)."""
        return self.teams[0].size

    @property
    def n_teams(self) -> int:
        return len(self.teams)

    @property
    def covers_world(self) -> bool:
        return self.n_teams * self.size == self.world_n

    def __repr__(self) -> str:
        return (f"TeamPartition({self.n_teams} teams x {self.size} PEs, "
                f"world_n={self.world_n})")

    def team_of(self, world_pe: int) -> Team:
        pe = int(world_pe)
        ti = self.team_id_np[pe] if 0 <= pe < self.world_n else -1
        if ti < 0:
            raise ValueError(f"PE {world_pe} is not in this partition")
        return self.teams[int(ti)]

    # -- lifting --------------------------------------------------------------
    def lift(self, pattern: PatternLike) -> CommPattern:
        """Union of every team's lift: one world pattern running all the
        teams' copies of a team-coordinate exchange concurrently."""
        p = as_pattern(pattern, self.size)
        got = self._lift_cache.get(p)
        if got is None:
            pairs = [(t.members[s], t.members[d])
                     for t in self.teams for s, d in p.pairs]
            got = as_pattern(pairs, self.world_n)
            self._lift_cache[p] = got
        return got

    def lift_schedule(self, sched: Schedule) -> Schedule:
        return Schedule(
            f"{sched.name}@part{self.n_teams}x{self.size}", tuple(
                Stage(self.lift(st.pattern), st.nbytes)
                for st in sched.stages))

    # -- the peer partition ---------------------------------------------------
    def complement(self) -> "TeamPartition":
        """The peer partition: team j = the rank-j member of every team
        (rows' complement is columns).  After an intra-team
        reduce-scatter each peer team's members own the SAME chunk index,
        which is exactly the group the hierarchical cross-step reduces
        over (DESIGN.md §11)."""
        if self._complement is None:
            peers = [make_team([t.members[j] for t in self.teams],
                               self.world_n) for j in range(self.size)]
            self._complement = TeamPartition(peers)
            self._complement._complement = self
        return self._complement


def split_2d(parent: Team, topo: MeshTopology, axis: int = -1
             ) -> TeamPartition:
    """Partition `parent` into the teams that vary only along `axis` of
    `topo` — rows (axis=-1) or columns (axis=0) of a 2D mesh, and the
    generalization for higher-rank meshes (e.g. axis=0 of a
    (pods, 16, 16) topology groups cross-pod replicas).

    `parent` must be closed under the split: every line of the mesh it
    touches must lie entirely inside it (true for the world team).
    Teams are ordered by the row-major rank of their first member, so
    ``split_2d(world, topo, -1).complement()`` is the column partition.
    """
    ndim = len(topo.shape)
    ax = axis % ndim
    if topo.n_pes != parent.world_n:
        raise ValueError(
            f"topology covers {topo.n_pes} PEs, world is {parent.world_n}")
    lines: dict[tuple[int, ...], list[int]] = {}
    order: list[tuple[int, ...]] = []
    for pe in parent.members:
        c = topo.coords(pe)
        key = c[:ax] + c[ax + 1:]
        if key not in lines:
            lines[key] = []
            order.append(key)
        lines[key].append(pe)
    extent = topo.shape[ax]
    for key, mem in lines.items():
        if len(mem) != extent:
            raise ValueError(
                f"parent team is not closed under axis {ax}: line {key} "
                f"has {len(mem)}/{extent} members")
    teams = [make_team(sorted(lines[k], key=lambda p: topo.coords(p)[ax]),
                       parent.world_n) for k in order]
    return TeamPartition(teams)


def cache_size() -> int:
    return len(_INTERN)
