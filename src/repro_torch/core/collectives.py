"""The paper's collective algorithms (§3.6), written once over NetOps.

Algorithm choices mirror the paper exactly:

  * barrier        — dissemination (ceil(log2 N) rounds, 8*log2(N) bytes of
                     sync state), or a binomial tree.
  * broadcast      — binomial tree, *farthest-first*: largest stride first
                     so later stages do not add network congestion.
  * fcollect       — recursive doubling for powers of two, ring otherwise.
  * collect        — ring (the paper's linear-scaling variant).
  * reductions     — dissemination/recursive-doubling for powers of two,
                     ring (reduce-scatter + allgather) otherwise.
  * alltoall       — pairwise exchange, one ring offset per stage.

Every algorithm is a ``*_schedule`` builder returning a
:class:`~repro_torch.core.pattern.Schedule` of compiled
:class:`~repro_torch.core.pattern.CommPattern` stages (DESIGN.md §9).  The
executor iterates the schedule's stages; the alpha-beta cost descriptor
(``*_stages``, the benchmarks' `derived` column, the roofline cross-check)
is ``schedule.cost(topo)`` on the *same object* — predicted and executed
schedules cannot drift apart.  `choose_algorithm` prices candidate
schedules with the cost model to pick the cheapest (`algorithm="auto"`).

All functions take the PE-stacked array of the SIM backend (one device
carries every PE; dim 0 is the PE axis).  PE ranks and every per-PE block
index are host numpy, turned into cached device tables: nothing in a
stage loop reads the device back.  On the card three kernels carry the
data (`kernels/`): every ppermute is one put_copy launch, every block
gather of a ring (`_take_blocks`) one dma_copy launch, and every stage
combine of a sum/prod/max/min reduction one reduce_combine launch.

`profile=` takes a :class:`~repro_torch.core.profile.Profiler`: each
executor notes the resolved algorithm, chunk count, embedding and schedule
on the innermost open op (DESIGN.md §13).  `tuner=` takes a
:class:`~repro_torch.core.tuner.TunedSelector`, consulted before the
analytic model by every ``choose_*``.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Sequence

import numpy as np
import torch

from ..kernels import put_copy as _pc
from ..kernels import reduce_combine as _rc
from .heap import tree_flatten
from .netops import NetOps, device_table, tree_map
from .pattern import (CommPattern, Schedule, Stage, as_pattern,
                      binomial_stage_pattern, intern_get, ring_pattern,
                      xor_pattern)
from . import team as team_mod


def _ceil_log2(n: int) -> int:
    return max(1, n - 1).bit_length() if n > 1 else 0


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _payload_bytes(net: NetOps, x) -> float:
    """Per-PE payload bytes of tree `x` (the SIM backend's leading PE axis
    is not payload)."""
    leaves, _ = tree_flatten(x)
    total = float(sum(l.numel() * l.element_size() for l in leaves))
    return total / net.n_pes


# ---------------------------------------------------------------------------
# team-relative execution view (DESIGN.md §11)
# ---------------------------------------------------------------------------
# Every executor below is written against a *group view*: my rank within
# the group, the group size, a lift of group-coordinate patterns to the
# world patterns that execute, and (for proper-subset teams) the member
# mask that bounds where results are defined.  team=None is the world —
# rank is the PE id and lift is the interning pass-through.

def _team_view(net: NetOps, team):
    """(rank, size, lift, member_mask) for `team`: a Team, a
    TeamPartition (all member teams run concurrently — each PE uses its
    own team's coordinates), or None for the world.

    rank is the host array of per-PE group ranks (clamped to 0 off-team;
    off-team results are masked out by the callers).  member_mask is a
    host bool array over world PEs, or None when the group covers the
    world."""
    if team is None:
        return np.arange(net.n_pes), net.n_pes, \
            (lambda p: as_pattern(p, net.n_pes)), None
    if team.world_n != net.n_pes:
        raise ValueError(f"team compiled for world_n={team.world_n} "
                         f"used on a {net.n_pes}-PE net")
    rank = np.maximum(team.rank_np, 0)
    mask = None if team.covers_world else team.member_np
    return rank, team.size, team.lift, mask


def _mask_out(net: NetOps, mask, out, keep=None):
    """Restore non-members: `keep` (same shape) where given, zeros for
    shape-changing collectives — OpenSHMEM leaves non-participants
    undefined; we pin them for determinism and testability."""
    if mask is None:
        return out
    keep = torch.zeros_like(out) if keep is None else keep
    return net.select(mask, out, keep)


# ---------------------------------------------------------------------------
# mesh embeddings — ring collectives in snake coordinates (DESIGN.md §12)
# ---------------------------------------------------------------------------
# An embedding is a world-covering rank order: ring position i is served by
# PE order[i].  With `topo.snake_order()` every logical ring hop becomes ONE
# physical hop and (on meshes with a Hamiltonian cycle) no two ring flows
# share a physical link — max_link_load 1 vs the logical ring's contended
# row-wrap columns.  Execution reuses the team machinery: the order IS a
# covering Team, so lifted patterns are interned and shared with the
# schedules that price them.

def _embedding_team(order: Sequence[int], world_n: int):
    return team_mod.make_team(order, world_n)


def embedding_team(embedding, topo, n: int, link=None):
    """Resolve the embedding knob straight to its world-covering Team (the
    coordinate system embedded rings execute in), or None when the
    identity/logical ring is the embedding.  The Comm/grad-sync layers use
    this to run reduce-scatter + allgather pairs in embedded coordinates."""
    order = _resolve_embedding(embedding, topo, n, link)
    return None if order is None else _embedding_team(order, n)


def _resolve_embedding(embedding, topo, n: int, link=None, tuner=None):
    """The embedding knob: None -> off; "snake" -> the topology's snake
    order; "auto" -> cost-model pick (snake vs a greedy remap vs identity,
    `choose_embedding`); an explicit order passes through validated.  Returns a world rank order,
    or None when the identity (logical ring) is the embedding."""
    if embedding is None:
        return None
    if isinstance(embedding, str):
        if embedding not in ("auto", "snake"):
            # validate BEFORE the topo gate: a typo'd knob must raise even
            # when no usable topology is attached (it would otherwise be
            # silently read as "off" exactly when the user can't notice)
            raise ValueError(f"unknown embedding {embedding!r} "
                             "(None | 'auto' | 'snake' | explicit order)")
        if topo is None or getattr(topo, "n_pes", None) != n:
            return None
        if embedding == "auto":
            return choose_embedding(n, topo, link, tuner=tuner)
        order = topo.snake_order()
        return None if order == tuple(range(n)) else order
    order = tuple(int(p) for p in embedding)
    if sorted(order) != list(range(n)):
        raise ValueError(f"embedding must be a permutation of 0..{n - 1}")
    return None if order == tuple(range(n)) else order


# Representative payload for embedding selection: large enough that the
# bandwidth (congestion) term dominates, where embeddings matter.
EMBED_REF_BYTES = float(1 << 20)
# Greedy remap is O(n^2) schedule evaluations per pass — worth it on
# chip-scale meshes, not on pod-scale ones (where the snake already wins).
EMBED_GREEDY_MAX_PES = 64

_EMBED_LOCK = threading.Lock()
_EMBED_CACHE: dict = {}
_EMBED_CACHE_MAX = 256


def choose_embedding(n: int, topo, link=None, tuner=None):
    """Cost-model embedding selection: price the ring allreduce schedule
    under the identity, the snake order, and (small meshes) a greedy
    `optimize_embedding` remap seeded from the snake; return the winning
    order, or None when the logical ring already prices best.  Cached per
    (topo, n, link).

    A `tuner` (``repro_torch.core.tuner.TunedSelector``) is consulted
    FIRST: when the tuning DB holds measurements near the reference
    payload for this topology, the measured-best embedding (identity /
    snake / an explicit order) overrides the analytic pricing (DESIGN.md
    §13)."""
    if topo is None or getattr(topo, "n_pes", None) != n or n <= 2:
        return None
    if tuner is not None:
        pick = tuner.embedding(n, EMBED_REF_BYTES, topo)
        if pick is not None:
            if pick == "identity":
                return None
            order = topo.snake_order() if pick == "snake" else tuple(pick)
            return None if order == tuple(range(n)) else order

    def _build():
        def _sched(order):
            if order is None:
                return allreduce_schedule(n, EMBED_REF_BYTES, "ring")
            return allreduce_schedule(n, EMBED_REF_BYTES, "ring_emb",
                                      embedding=order)

        snake = topo.snake_order()
        candidates: list[tuple[int, ...] | None] = [None]
        if snake != tuple(range(n)):
            candidates.append(snake)
            if n <= EMBED_GREEDY_MAX_PES:
                _, perm = optimize_embedding(_sched(snake), topo, link)
                greedy = tuple(perm[p] for p in snake)
                if greedy not in candidates:
                    candidates.append(greedy)
        # boxed so an identity result (None) still caches — intern_get
        # treats a bare None as a miss
        return (min(candidates, key=lambda o: _sched(o).time(topo, link)),)

    return intern_get(_EMBED_CACHE, _EMBED_LOCK, _EMBED_CACHE_MAX,
                      (topo, n, link), _build)[0]


def optimize_embedding(schedule: Schedule, topo, link=None,
                       max_passes: int = 2
                       ) -> tuple[Schedule, tuple[int, ...]]:
    """Greedy rank remap: hill-climb pairwise PE swaps that lower the
    congestion-priced time (dominated by ``max_link_load``) of the
    schedule's stages on `topo`.  Returns ``(remapped_schedule, perm)``
    with ``perm[old_pe] = new_pe`` — stage patterns are relabeled through
    `perm` (`CommPattern.relabel`, interned as usual).

    The remapped schedule is a *different coordinate system*, not a
    drop-in replacement: run it by treating `perm` as an embedding (the
    covering Team whose rank r is PE ``perm[order[r]]``), exactly how the
    `embedding=` knob executes — data placement follows the relabel."""
    if not schedule.stages:
        return schedule, ()
    from . import abmodel
    n = schedule.stages[0].pattern.n_pes
    perm = list(range(n))
    lk = link if link is not None else abmodel.ICI_V5E
    # ring schedules repeat ONE (pattern, bytes) stage 2(n-1) times —
    # price each unique stage once and weight by its count, instead of
    # rebuilding the full Schedule per candidate swap
    uniq: dict[tuple[CommPattern, float], int] = {}
    for st in schedule.stages:
        key = (st.pattern, st.nbytes)
        uniq[key] = uniq.get(key, 0) + 1

    def _priced(p: Sequence[int]) -> float:
        # score the remapped pairs directly — interning a throwaway
        # CommPattern per candidate swap would churn the global pattern
        # cache (and its device/hop caches) with never-reused entries
        total = 0.0
        for (pat, nb), cnt in uniq.items():
            pairs = [(p[s], p[d]) for s, d in pat.pairs]
            if topo is None:
                hops = load = 1.0 if pairs else 0.0
            else:
                hops = max((topo.hops(s, d) for s, d in pairs), default=0.0)
                loads: dict[tuple[int, int], float] = {}
                for s, d in pairs:
                    if s == d:
                        continue
                    for u, v in topo.route(s, d):
                        key = (u, v) if u < v else (v, u)
                        loads[key] = loads.get(key, 0.0) + 1.0
                load = max(loads.values()) if loads \
                    else (1.0 if pairs else 0.0)
            total += cnt * lk.time(nb, hops, load)
        return total

    def _relabel(p: Sequence[int]) -> Schedule:
        return Schedule(f"{schedule.name}.remap", tuple(
            Stage(st.pattern.relabel(p, n), st.nbytes)
            for st in schedule.stages))

    best_t = _priced(perm)
    for _ in range(max_passes):
        improved = False
        for i in range(n):
            for j in range(i + 1, n):
                perm[i], perm[j] = perm[j], perm[i]
                t = _priced(perm)
                if t < best_t - 1e-15:
                    best_t, improved = t, True
                else:
                    perm[i], perm[j] = perm[j], perm[i]
        if not improved:
            break
    return _relabel(perm), tuple(perm)


def embed_team(team, topo, order=None):
    """The embedding computed in TEAM coordinates: reorder a team's
    members along the world embedding order (the topology's snake by
    default; pass `order` to honor an explicit/greedy world order), so
    the team-relative ring lifts to near-neighbor world flows
    (DESIGN.md §12).  Interned (teams are); returns the same team when
    the order already matches or no usable topology is given."""
    if order is None:
        if topo is None or getattr(topo, "n_pes", None) != team.world_n:
            return team
        order = topo.snake_order()
    pos = {pe: i for i, pe in enumerate(order)}
    members = tuple(sorted(team.members, key=lambda p: pos[p]))
    if members == team.members:
        return team
    return team_mod.make_team(members, team.world_n)


def _team_embed_view(team, topo, embedding, link=None):
    """Resolve the embedding knob to the embedded TEAM view, honoring the
    same world-order semantics as the flat path: strings are validated
    ("auto"/"snake"; typos raise), explicit world orders are honored, a
    knob resolving to the identity leaves the team untouched, and
    embedding=None (an explicit algorithm="ring_emb" request) takes the
    snake default."""
    if embedding is None:
        return embed_team(team, topo)
    order = _resolve_embedding(embedding, topo, team.world_n, link)
    if order is None:
        return team                  # knob resolves to the identity
    return embed_team(team, topo, order)


_EMBED_PART_LOCK = threading.Lock()
_EMBED_PART_CACHE: dict = {}


def _embed_partition(partition, topo, embedding=None, link=None):
    """embed_team over every member team of a partition (the hierarchical
    allreduce's intra phases then ride embedded rings), against the SAME
    world order the flat path would resolve from the knob — an explicit
    or "auto"/greedy order is honored, not silently replaced by the
    snake.  Cached per (partition, topo, order) so lift caches survive
    across calls."""
    if topo is None:
        return partition
    order = _resolve_embedding(embedding, topo, partition.world_n, link) \
        if embedding is not None else None
    if embedding is not None and order is None:
        return partition            # knob resolves to the identity

    def _build():
        teams = [embed_team(t, topo, order) for t in partition.teams]
        if all(a is b for a, b in zip(teams, partition.teams)):
            return partition
        return team_mod.TeamPartition(teams)

    return intern_get(_EMBED_PART_CACHE, _EMBED_PART_LOCK, 256,
                      (partition, topo, order), _build)


# ---------------------------------------------------------------------------
# schedule builders — one per paper algorithm
# ---------------------------------------------------------------------------

def _ring_stage_pattern(n: int, embedding=None) -> CommPattern:
    """The offset-1 ring stage, optionally in embedding coordinates:
    ring position i (PE embedding[i]) sends to position i+1.  The lifted
    object is the SAME interned pattern the embedded executor runs."""
    p = ring_pattern(n)
    return p if embedding is None else p.relabel(embedding, n)


def barrier_schedule(n: int, algorithm: str = "dissem") -> Schedule:
    """"dissem": round k exchanges 8 bytes of sync state with PE (i + 2^k)
    — the paper's 8*log2(N) sync array.  "tree": binomial gather to PE 0
    then binomial broadcast — 2x the rounds but each round is a sparse
    tree stage, the low-congestion candidate `choose_barrier` prices
    against dissemination's dense all-PE exchanges."""
    if algorithm == "tree":
        gather = [Stage(binomial_stage_pattern(n, 1 << k).inverse, 8.0)
                  for k in range(_ceil_log2(n))]
        bcast = [Stage(binomial_stage_pattern(n, 1 << k), 8.0)
                 for k in reversed(range(_ceil_log2(n)))]
        return Schedule("barrier.tree", tuple(gather + bcast))
    return Schedule("barrier.dissemination", tuple(
        Stage(ring_pattern(n, 1 << k), 8.0) for k in range(_ceil_log2(n))))


def choose_barrier(n: int, topo=None, link=None, team=None) -> str:
    """Price the dissemination barrier against the tree barrier with the
    congestion-aware model and return the cheaper ("dissem" | "tree").
    With `team`, candidates are lifted to the world flows that execute
    before pricing (team ranks are not world PEs)."""
    if n <= 1:
        return "dissem"

    def _priced(a: str) -> float:
        s = barrier_schedule(n, a)
        if team is not None:
            s = team.lift_schedule(s)
        return s.time(topo, link)

    return min(("dissem", "tree"), key=_priced)


def broadcast_schedule(n: int, nbytes: float = 0.0, root: int = 0) -> Schedule:
    """Farthest-first binomial tree: stride p2/2 down to 1 (paper §3.6:
    'moving the data the farthest distance first')."""
    stages = []
    stride = (1 << _ceil_log2(n)) >> 1
    while stride >= 1:
        stages.append(Stage(binomial_stage_pattern(n, stride, root),
                            float(nbytes)))
        stride >>= 1
    return Schedule("broadcast.binomial_ff", tuple(stages))


def fcollect_schedule(n: int, nbytes: float = 0.0,
                      algorithm: str | None = None,
                      embedding=None) -> Schedule:
    """Allgather of `nbytes` blocks: recursive doubling (payload doubles
    per stage), ring (n-1 single-block stages), or the mesh-embedded ring
    ("ring_emb": every hop one physical hop over `embedding`)."""
    algo = algorithm or ("rd" if _is_pow2(n) else "ring")
    if algo == "rd":
        return Schedule("fcollect.rd", tuple(
            Stage(xor_pattern(n, 1 << k), nbytes * (1 << k))
            for k in range(_ceil_log2(n))))
    emb = embedding if algo == "ring_emb" else None
    return Schedule("fcollect.ring_emb" if emb is not None
                    else "fcollect.ring", tuple(
                        Stage(_ring_stage_pattern(n, emb), float(nbytes))
                        for _ in range(max(n - 1, 0))))


def reduce_scatter_schedule(n: int, nbytes: float = 0.0,
                            embedding=None) -> Schedule:
    """Ring reduce-scatter: n-1 stages, each moving one 1/n chunk (over
    the embedding order when one is given)."""
    return Schedule("reduce_scatter.ring", tuple(
        Stage(_ring_stage_pattern(n, embedding), nbytes / max(n, 1))
        for _ in range(max(n - 1, 0))))


def allgather_schedule(n: int, nbytes: float = 0.0,
                       embedding=None) -> Schedule:
    """Ring allgather of the scattered 1/n chunks (reduce-scatter's dual)."""
    return Schedule("allgather.ring", tuple(
        Stage(_ring_stage_pattern(n, embedding), nbytes / max(n, 1))
        for _ in range(max(n - 1, 0))))


def allreduce_schedule(n: int, nbytes: float = 0.0,
                       algorithm: str | None = None,
                       embedding=None) -> Schedule:
    """to_all: recursive doubling (log2 N full-buffer stages,
    alpha-optimal), ring reduce-scatter + allgather (~2x buffer total,
    bandwidth-optimal), or the mesh-embedded ring ("ring_emb": the same
    ring in snake coordinates — one physical hop per stage, hot-link
    load 1 where the topology admits a Hamiltonian cycle)."""
    algo = algorithm or ("rd" if _is_pow2(n) else "ring")
    if algo == "rd":
        return Schedule("allreduce.rd", tuple(
            Stage(xor_pattern(n, 1 << k), float(nbytes))
            for k in range(_ceil_log2(n))))
    emb = embedding if algo == "ring_emb" else None
    return Schedule("allreduce.ring_emb" if emb is not None
                    else "allreduce.ring",
                    reduce_scatter_schedule(n, nbytes, emb).stages
                    + allgather_schedule(n, nbytes, emb).stages)


def alltoall_schedule(n: int, nbytes_total: float = 0.0) -> Schedule:
    """Pairwise exchange (paper Fig. 9): stage j sends one 1/n block to the
    PE j ring offsets away."""
    per = nbytes_total / max(n, 1)
    return Schedule("alltoall.pairwise", tuple(
        Stage(ring_pattern(n, j), per) for j in range(1, n)))


# Collectives with more than one algorithm to choose between.
_SELECTABLE: dict[str, Callable[..., Schedule]] = {
    "allreduce": allreduce_schedule,
    "fcollect": fcollect_schedule,
}


def allreduce_hier_schedule(partition, nbytes: float = 0.0,
                            cross_algorithm: str | None = None,
                            topo=None, link=None, embedding=None) -> Schedule:
    """The hierarchical two-level allreduce as ONE world Schedule
    (DESIGN.md §11): intra-team ring reduce-scatter, cross-team allreduce
    of the owned 1/K chunk over the peer teams (the partition's
    complement — every team's rank-j members), intra-team ring allgather.
    Each phase's team-coordinate stages lift to union patterns, so all
    teams fly their stage-k exchange concurrently; stage payloads and hop
    costs come from the lifted objects that execute.  cross_algorithm
    None cost-model-selects the cross step (rd's log2(M) chunk sends vs
    the ring's ~2x chunk bytes), same as the executor.  `embedding`
    non-None reorders each member team along the topology's snake
    (`embed_team`) before lifting — the intra phases then ride embedded
    rings, mirroring the executor's `_embed_partition`."""
    if embedding is not None:
        partition = _embed_partition(partition, topo,
                                     embedding=embedding,
                                     link=link)
    K = partition.size
    peers = partition.complement()
    if cross_algorithm is None:
        cross_algorithm = choose_algorithm(peers.size, nbytes / max(K, 1),
                                           topo, link, team=peers)
    stages = tuple(
        partition.lift_schedule(reduce_scatter_schedule(K, nbytes)).stages
        + peers.lift_schedule(
            allreduce_schedule(peers.size, nbytes / max(K, 1),
                               cross_algorithm)).stages
        + partition.lift_schedule(allgather_schedule(K, nbytes)).stages)
    return Schedule(
        f"allreduce.hier[{partition.n_teams}x{K}]", stages)


def allreduce_hier(net: NetOps, x, op: str = "sum",
                   combine: Callable | None = None, partition=None,
                   cross_algorithm: str | None = None, topo=None, link=None,
                   embedding=None):
    """Hierarchical two-level allreduce over a covering TeamPartition:

      1. intra-team ring reduce-scatter — team rank r ends up owning the
         team-reduced chunk (r+1) mod K;
      2. cross-team allreduce among the chunk owners: the peer teams
         (partition.complement(), every team's rank-j members) each hold
         the SAME chunk index, so reducing within a peer team completes
         that chunk globally;
      3. intra-team ring allgather of the completed chunks.

    Numerically this reorders the summation relative to the flat
    algorithms — exact for int dtypes, allclose within float tolerance
    (documented in DESIGN.md §11).  On a 2D mesh with row teams this
    keeps phases 1/3 on row links and moves only 1/K of the payload
    across rows — the fewest-largest-messages policy of §8."""
    if partition is None:
        raise ValueError("allreduce_hier needs a TeamPartition")
    if not partition.covers_world:
        raise ValueError("allreduce_hier needs a partition covering the "
                         "world (every PE contributes)")
    fn = combine or OPS[op]
    if embedding is not None:
        partition = _embed_partition(partition, topo,
                                     embedding=embedding,
                                     link=link)
    peers = partition.complement()
    if cross_algorithm is None:
        # cost-model-select the cross step from the UNPADDED chunk bytes,
        # exactly as allreduce_hier_schedule prices it — the executed and
        # priced algorithms cannot diverge (even when padding rounds the
        # actual chunk up)
        nbytes = _payload_bytes(net, x)
        cross_algorithm = choose_algorithm(
            peers.size, nbytes / max(partition.size, 1), topo, link,
            team=peers)
    own, info = _reduce_scatter_ring(net, x, fn, team=partition)
    if peers.size > 1:
        own = allreduce(net, own, op, combine=combine,
                        algorithm=cross_algorithm, team=peers,
                        topo=topo, link=link)
    return allgather_unpad(net, own, info, team=partition)


def choose_algorithm(n: int, nbytes: float, topo=None, link=None,
                     collective: str = "allreduce", team=None,
                     partition=None, embedding=None, tuner=None) -> str:
    """Cost-model algorithm selection: price each candidate schedule with
    the congestion-aware alpha-beta model on `topo`/`link` and take the
    cheapest.

    This replaces the hand-tuned byte-threshold switch: recursive doubling
    pays log2(N) full-payload sends (alpha-optimal), the ring pays ~2x the
    payload in 2(N-1) chunk sends (bandwidth-optimal); where the cross-over
    falls depends on alpha, beta AND the mesh hop/contention costs, which
    is exactly what the model prices.

    With `team`, candidates are priced in team coordinates (lifted to the
    world patterns that execute, so team hop costs are the members' world
    distances).  With `partition` (allreduce only), the hierarchical
    two-level schedule joins the candidate set — "hier" wins whenever
    keeping the bulk bytes on intra-team links beats the flat ring.  With
    `embedding` enabled ("auto"/"snake"/an order), the mesh-embedded ring
    "ring_emb" joins too (DESIGN.md §12) — one physical hop per stage,
    hot-link load 1 where the mesh admits a Hamiltonian cycle.

    A `tuner` (``repro_torch.core.tuner.TunedSelector``) is consulted
    FIRST: the measured-best algorithm among the legal candidates
    overrides the analytic pricing; unmeasured points fall through to the
    model (DESIGN.md §13 precedence)."""
    if team is not None:
        n = team.size
    if n <= 1:
        return "ring"
    build = _SELECTABLE[collective]
    emb_view = None          # the embedded TEAM view (team path only)
    emb = None               # the world embedding order (flat path only)
    if team is not None:
        if embedding is not None:
            reordered = _team_embed_view(team, topo, embedding, link)
            emb_view = None if reordered is team else reordered
    else:
        emb = _resolve_embedding(embedding, topo, n, link, tuner=tuner)

    def _priced(a: str) -> float:
        if a == "hier":
            return allreduce_hier_schedule(
                partition, nbytes, topo=topo, link=link,
                embedding=embedding).time(topo, link)
        if team is not None:
            view = emb_view if a == "ring_emb" else team
            algo = "ring" if a == "ring_emb" else a
            return view.lift_schedule(
                build(n, nbytes, algorithm=algo)).time(topo, link)
        return build(n, nbytes, algorithm=a,
                     embedding=emb if a == "ring_emb" else None
                     ).time(topo, link)

    candidates = ["ring"] + (["rd"] if _is_pow2(n) else [])
    if emb is not None or emb_view is not None:
        candidates.append("ring_emb")
    if (partition is not None and team is None and collective == "allreduce"
            and partition.covers_world and partition.n_teams > 1
            and partition.size > 1):
        candidates.append("hier")
    if tuner is not None and team is None:
        # measured-first, restricted to the legal candidate set so knob
        # changes degrade to the best measured candidate that still runs
        pick = tuner.algorithm(collective, n, nbytes, topo,
                               candidates=candidates)
        if pick is not None:
            return pick
    return min(candidates, key=_priced)


# Upper bound on pipeline depth "auto" will consider; deeper pipelines pay
# one more per-stage alpha per chunk for ever-shrinking drain savings.
PIPELINE_MAX_CHUNKS = 16


def choose_schedule(n: int, nbytes: float, topo=None, link=None,
                    collective: str = "allreduce",
                    max_chunks: int = PIPELINE_MAX_CHUNKS,
                    partition=None, embedding=None,
                    tuner=None) -> tuple[str, int]:
    """choose_algorithm extended over the pipelining axis: price every
    candidate (algorithm, chunk-count) pair with the alpha-beta model —
    `abmodel.modeled_pipelined_time` for chunked, eq. 1 for monolithic —
    and return the cheapest ``(algorithm, n_chunks)``.

    n_chunks == 1 means monolithic execution; above the modeled pipelining
    cross-over (where the drained bandwidth saving outweighs the per-chunk
    alpha) the chunk count grows toward `max_chunks`.  With `partition`
    (allreduce only) the hierarchical schedule competes too — priced
    monolithic, since team-relative execution does not pipeline
    (DESIGN.md §11).  With `embedding` enabled, the mesh-embedded ring
    competes at every chunk count (it pipelines like the logical ring,
    DESIGN.md §12)."""
    from . import abmodel
    if n <= 1:
        return "ring", 1
    link = link if link is not None else abmodel.ICI_V5E
    build = _SELECTABLE[collective]
    emb = _resolve_embedding(embedding, topo, n, link, tuner=tuner)
    best, best_t = ("ring", 1), math.inf
    algos = ["ring"] + (["rd"] if _is_pow2(n) else []) \
        + (["ring_emb"] if emb is not None else [])
    hier_ok = (partition is not None and collective == "allreduce"
               and partition.covers_world and partition.n_teams > 1
               and partition.size > 1)
    if tuner is not None:
        # measured-best (algorithm, chunk-count) pair for this point
        # (DESIGN.md §13); the analytic pricing below is the fallback
        pick = tuner.schedule(collective, n, nbytes, topo,
                              algos=algos + (["hier"] if hier_ok else []),
                              max_chunks=max_chunks)
        if pick is not None:
            return ("hier", 1) if pick[0] == "hier" else pick
    for algo in algos:
        cost = build(n, nbytes, algorithm=algo,
                     embedding=emb if algo == "ring_emb" else None
                     ).cost(topo)
        c = abmodel.choose_chunks(cost, link, max_chunks=max_chunks)
        t = abmodel.modeled_pipelined_time(cost, c, link)
        if t < best_t:
            best, best_t = (algo, c), t
    if hier_ok:
        t = allreduce_hier_schedule(
            partition, nbytes, topo=topo, link=link,
            embedding=embedding).time(topo, link)
        if t < best_t:
            best, best_t = ("hier", 1), t
    return best


# ---------------------------------------------------------------------------
# cost descriptors — thin views over the same schedules that execute
# ---------------------------------------------------------------------------

def barrier_stages(n: int, topo=None) -> list[tuple[float, float, float]]:
    """[(bytes, hops, max_link_load)] per stage for the cost model."""
    return barrier_schedule(n).cost(topo)


def broadcast_stages(n: int, nbytes: float, topo=None):
    return broadcast_schedule(n, nbytes).cost(topo)


def fcollect_stages(n: int, nbytes: float, topo=None, algorithm=None):
    return fcollect_schedule(n, nbytes, algorithm).cost(topo)


def allreduce_stages(n: int, nbytes: float, topo=None, algorithm=None):
    return allreduce_schedule(n, nbytes, algorithm).cost(topo)


def alltoall_stages(n: int, nbytes_total: float, topo=None):
    return alltoall_schedule(n, nbytes_total).cost(topo)


# ---------------------------------------------------------------------------
# pipelined (chunked, double-buffered) schedule execution — DESIGN.md §10
# ---------------------------------------------------------------------------
# Large payloads split into static contiguous pieces; the executor issues
# stage k of piece c at pipeline step k + c, so stage k of chunk i overlaps
# stage k+1 of chunk i-1 (the paper's e-DMA double-buffering discipline).
# Pieces are dataflow-independent and every stage op (ppermute, select,
# elementwise combine, static block slicing) commutes with contiguous
# slicing of the payload, so pipelined execution is BIT-IDENTICAL to the
# eager/monolithic path — same ops, same per-element reduction order.

def _chunk_bounds(width: int, n_chunks) -> list[tuple[int, int]]:
    """Static contiguous piece boundaries (roughly equal; always at least
    one piece, so zero-width payloads still run a single empty piece)."""
    c = max(1, min(int(n_chunks), int(width)))
    if width <= 0:
        return [(0, 0)]
    edges = np.linspace(0, width, c + 1).astype(int)
    return [(int(lo), int(hi)) for lo, hi in zip(edges[:-1], edges[1:])
            if hi > lo]


def _software_pipeline(pieces, n_stages: int, stage_fn):
    """Run `stage_fn(piece_idx, stage_idx, state) -> state` over all pieces
    in pipelined issue order: step t advances piece c through stage t - c.
    Fill takes S steps, drain C-1 — the (S + C - 1)-slot pipeline that
    `abmodel.modeled_pipelined_time` prices."""
    states = list(pieces)
    n_pieces = len(states)
    for t in range(n_stages + n_pieces - 1):
        for c in range(n_pieces):
            k = t - c
            if 0 <= k < n_stages:
                states[c] = stage_fn(c, k, states[c])
    return states


def _resolve_chunks(pipeline_chunks, schedule: Schedule, topo=None,
                    link=None, tuner=None, key: tuple | None = None) -> int:
    """None/1 -> monolithic; "auto" -> abmodel.choose_chunks on the
    executing schedule's own cost descriptor (measured-first when a
    `tuner` and a ``(collective, algorithm, n, nbytes, topo)`` key are
    threaded); an int passes through."""
    if pipeline_chunks in (None, 0, 1):
        return 1
    if pipeline_chunks == "auto":
        from . import abmodel
        link = link if link is not None else abmodel.ICI_V5E
        return abmodel.choose_chunks(schedule.cost(topo), link,
                                     max_chunks=PIPELINE_MAX_CHUNKS,
                                     tuner=tuner, key=key)
    return int(pipeline_chunks)


def _slice_axis(v, lo: int, hi: int, ax: int):
    return v.narrow(ax, lo, hi - lo)


def _flat_pieces(net: NetOps, x, n_chunks):
    """Flatten the per-PE payload and cut it into static contiguous pieces;
    returns (pieces, bounds, restore)."""
    shape = x.shape
    flat = x.reshape(shape[0], -1)
    bounds = _chunk_bounds(flat.shape[-1], n_chunks)
    pieces = [flat[:, lo:hi] for lo, hi in bounds]

    def restore(parts):
        return torch.cat(parts, dim=-1).reshape(shape)

    return pieces, bounds, restore


def _interleave_blocks(outs, bounds, n: int, ax: int):
    """Inverse of within-block chunking: each per-piece output carries `n`
    blocks of its piece's width along `ax`; reassemble the n full blocks
    (block i = concat over pieces of each piece's block i)."""
    cols = []
    for i in range(n):
        for out, (lo, hi) in zip(outs, bounds):
            w = hi - lo
            cols.append(_slice_axis(out, i * w, (i + 1) * w, ax))
    return torch.cat(cols, dim=ax)




# ---------------------------------------------------------------------------
# block movement on the PE-stacked layout — the DMA engine's work
# ---------------------------------------------------------------------------
# A per-PE array v (PE p's row of the stacked x) whose `axis` holds nblk
# blocks is viewed as a 2D (n_pes * pre, nblk * B) element array: pre =
# the per-PE dims before `axis`, B = block length * the dims after it.
# Every per-PE block move is then one 2D descriptor, and a whole gather of
# blocks is ONE dma_copy launch.

_PLAN_LOCK = threading.Lock()
_PLANS: dict = {}


def _block_geometry(x, nblk: int, axis: int) -> tuple[int, int]:
    """(pre, B) of the 2D view above."""
    ax = axis + 1
    pre = math.prod(x.shape[1:ax])
    return pre, (x.shape[ax] // nblk) * math.prod(x.shape[ax + 1:])


def _plan(kind: str, idx: np.ndarray, pre: int, B: int, n_src: int,
          n_dst: int) -> _pc.DmaPlan:
    """The DmaPlan moving, for each PE p and slot t, block idx[p, t] of a
    PE row with `n_src` blocks to block t of one with `n_dst` ("take"), or
    block t to block idx[p, t] ("place").  Cached per geometry."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    key = (kind, idx.tobytes(), idx.shape, pre, B, n_src, n_dst)

    def build():
        n_pes, k = idx.shape
        row = np.repeat(np.arange(n_pes) * pre, k)
        slot = np.tile(np.arange(k), n_pes)
        blk = idx.reshape(-1)
        src_blk, dst_blk = (blk, slot) if kind == "take" else (slot, blk)
        descs = np.stack([row, src_blk * B, row, dst_blk * B,
                          np.full_like(row, pre), np.full_like(row, B)], 1)
        return _pc.DmaPlan(descs, (n_pes * pre, n_src * B),
                           (n_pes * pre, n_dst * B))

    return intern_get(_PLANS, _PLAN_LOCK, 1024, key, build)


def _take_blocks(net: NetOps, x, idx, nblk: int, axis: int):
    """out block t = x block idx[pe, t] (idx: host table, one row per
    PE), one dma_copy launch."""
    pre, B = _block_geometry(x, nblk, axis)
    if x.numel() == 0:
        return x.clone()
    plan = _plan("take", idx, pre, B, nblk, nblk)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _pc.dma_copy(x.reshape(plan.src_shape), out.view(plan.dst_shape), plan)
    return out


def _place_blocks(net: NetOps, x, rank, n: int, axis: int):
    """A zero buffer of n blocks along `axis` per PE with PE p's x at block
    rank[p], one dma_copy launch."""
    ax = axis + 1
    shape = list(x.shape)
    shape[ax] *= n
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    pre, B = _block_geometry(x, 1, axis)
    if x.numel() == 0:
        return buf
    plan = _plan("place", np.asarray(rank).reshape(-1, 1), pre, B, 1, n)
    _pc.dma_copy(x.reshape(plan.src_shape), buf.view(plan.dst_shape), plan)
    return buf


def _permute_blocks_static(net: NetOps, x, idx_np, n: int, axis: int):
    """out block t = x block idx_np[t] — a HOST-constant block gather
    (same for every PE), the post-pass that restores world block order
    after an embedded ring ran in snake coordinates."""
    idx = np.broadcast_to(np.asarray(idx_np), (net.n_pes, n))
    return _take_blocks(net, x, idx, n, axis)


# ---------------------------------------------------------------------------
# barrier
# ---------------------------------------------------------------------------

def barrier(net: NetOps, token=None, team=None, algorithm: str | None = None,
            topo=None, link=None, profile=None):
    """Software barrier: dissemination (default — round k exchanges a
    token with rank (i + 2^k) of the group) or "tree" (binomial gather to
    rank 0, then binomial broadcast — sparser rounds, the low-congestion
    alternative); "auto" prices the two with the congestion model
    (`choose_barrier`).  `team`-relative ranks when a team is given.

    Returns the per-PE token; thread it into downstream computation to
    order operations ('all cores reached this line')."""
    _, n, lift, _ = _team_view(net, team)
    algo = algorithm or "dissem"
    if algo == "auto":
        algo = choose_barrier(n, topo, link, team=team)
    if profile is not None:
        profile.note(algorithm=algo, schedule=barrier_schedule(n, algo),
                     topo=topo, link=link, collective="barrier", n_pes=n)
    tok = torch.zeros((), dtype=torch.int32, device=net.device) \
        if token is None else token
    if tok.dim() == 0:
        tok = tok.expand(net.n_pes).clone()
    stages = barrier_schedule(n, algo).stages
    if algo == "tree":
        n_gather = _ceil_log2(n)
        for st in stages[:n_gather]:          # reduce partial sums to rank 0
            tok = tok + net.ppermute(tok, lift(st.pattern))
        for st in stages[n_gather:]:          # broadcast the root's token
            p = lift(st.pattern)
            tok = net.select(p, net.ppermute(tok, p), tok)
        return tok
    for st in stages:
        tok = tok + net.ppermute(tok, lift(st.pattern))
    return tok


# ---------------------------------------------------------------------------
# broadcast (farthest-first binomial tree)
# ---------------------------------------------------------------------------

def broadcast(net: NetOps, x, root: int = 0, pipeline_chunks=None,
              topo=None, link=None, team=None, profile=None, tuner=None):
    """Farthest-first binomial broadcast; with `team`, `root` is a TEAM
    rank and only members take the root's value (non-members keep x)."""
    _, n, lift, _ = _team_view(net, team)
    if n == 1:
        return x
    nbytes = _payload_bytes(net, x)
    sched = broadcast_schedule(n, nbytes, root)
    chunks = _resolve_chunks(pipeline_chunks, sched, topo, link, tuner,
                             ("broadcast", "binomial_ff", n, nbytes, topo)) \
        if team is None else 1
    if profile is not None:
        profile.note(algorithm="binomial_ff", chunks=chunks, schedule=sched,
                     topo=topo, link=link, collective="broadcast",
                     nbytes=nbytes, n_pes=n)
    if chunks > 1:
        pieces, _, restore = _flat_pieces(net, x, chunks)

        def stage(c, k, buf):
            st = sched.stages[k]
            recv = net.ppermute(buf, st.pattern)
            return net.select(st.pattern, recv, buf)

        return restore(_software_pipeline(pieces, len(sched.stages), stage))
    buf = x
    for st in sched.stages:
        p = lift(st.pattern)
        recv = net.ppermute(buf, p)
        buf = net.select(p, recv, buf)
    return buf


# ---------------------------------------------------------------------------
# fcollect / collect (allgather)
# ---------------------------------------------------------------------------

def fcollect(net: NetOps, x, axis: int = 0, algorithm: str | None = None,
             pipeline_chunks=None, topo=None, link=None, team=None,
             embedding=None, profile=None, tuner=None):
    """Concatenate equal-size blocks from all group members along `axis`.

    Recursive doubling (log2 N stages, doubling message size) when the
    group size is a power of two, ring otherwise — the paper's
    fcollect/collect split.  "auto" cost-model-selects; "ring_emb" (or an
    enabled `embedding` with the ring) runs the MESH-EMBEDDED ring: the
    ring in snake coordinates, with one static block permutation restoring
    PE order afterwards — the output is bit-identical to the logical ring
    (pure data movement), only the flows change (DESIGN.md §12).
    `pipeline_chunks` > 1 executes the schedule chunked/double-buffered
    (bit-identical; §10).  With `team`, blocks concatenate in TEAM-rank
    order; non-members return zeros (team collectives run monolithic,
    §11)."""
    _, n, _, _ = _team_view(net, team)
    if n == 1:
        return x
    emb = _resolve_embedding(embedding, topo, n, link, tuner=tuner) \
        if team is None else None
    nbytes = _payload_bytes(net, x)
    if algorithm == "auto":
        # teams take the raw knob (choose_algorithm prices the embedded
        # team view); the flat path passes the resolved order
        algo = choose_algorithm(n, nbytes, topo, link, collective="fcollect",
                                team=team,
                                embedding=emb if team is None else embedding,
                                tuner=tuner)
    else:
        algo = algorithm or ("rd" if _is_pow2(n) else "ring")
        if algorithm is None and algo == "ring" and (
                emb is not None
                or (team is not None and embedding is not None)):
            algo = "ring_emb"       # default policy + enabled embedding
    if algo == "ring_emb":
        if team is not None:        # embedding in team coordinates (§12)
            if profile is not None:
                profile.note(algorithm="ring_emb", collective="fcollect",
                             nbytes=nbytes, n_pes=n)
            return _collect_ring_team_embedded(net, x, axis, team, topo,
                                               embedding, link)
        if emb is None:
            # explicit algorithm= without the knob: snake default (as
            # allreduce); stays "ring" when no usable topology exists
            emb = _resolve_embedding("snake", topo, n, link)
        if emb is None:
            algo = "ring"                     # no usable embedding: logical
    sched = fcollect_schedule(n, nbytes, algo,
                              embedding=emb if algo == "ring_emb" else None)
    chunks = 1 if team is not None else _resolve_chunks(
        pipeline_chunks, sched, topo, link, tuner,
        ("fcollect", algo, n, nbytes, topo))
    if profile is not None:
        profile.note(algorithm=algo, chunks=chunks, schedule=sched,
                     topo=topo, link=link, collective="fcollect",
                     nbytes=nbytes, n_pes=n,
                     embedding=emb if algo == "ring_emb" else None)
    if algo == "ring_emb":
        return _collect_ring_embedded(net, x, axis, emb, n_chunks=chunks)
    if algo == "rd":
        return _fcollect_rd(net, x, axis, n_chunks=chunks, team=team)
    return _collect_ring(net, x, axis, n_chunks=chunks, team=team)


def collect(net: NetOps, x, axis: int = 0, pipeline_chunks=None,
            topo=None, link=None, team=None, embedding=None, profile=None,
            tuner=None):
    """The paper's linear-scaling ring collect (mesh-embedded when
    `embedding` is enabled — bit-identical output, near-neighbor flows)."""
    _, n, _, _ = _team_view(net, team)
    if n == 1:
        return x
    nbytes = _payload_bytes(net, x)
    if team is not None and embedding is not None:
        if profile is not None:
            profile.note(algorithm="ring_emb", collective="collect",
                         nbytes=nbytes, n_pes=n)
        return _collect_ring_team_embedded(net, x, axis, team, topo,
                                           embedding, link)
    emb = _resolve_embedding(embedding, topo, n, link, tuner=tuner) \
        if team is None else None
    algo = "ring_emb" if emb is not None else "ring"
    sched = fcollect_schedule(n, nbytes, algo, embedding=emb)
    chunks = 1 if team is not None else _resolve_chunks(
        pipeline_chunks, sched, topo, link, tuner,
        ("collect", algo, n, nbytes, topo))
    if profile is not None:
        profile.note(algorithm=algo, chunks=chunks, schedule=sched,
                     topo=topo, link=link, collective="collect",
                     nbytes=nbytes, n_pes=n, embedding=emb)
    if emb is not None:
        return _collect_ring_embedded(net, x, axis, emb, n_chunks=chunks)
    return _collect_ring(net, x, axis, n_chunks=chunks, team=team)


def _collect_ring_team_embedded(net: NetOps, x, axis: int, team, topo,
                                embedding=None, link=None):
    """Team-scoped embedded ring collect: run the ring over the team
    REORDERED along the world embedding order (`_team_embed_view` — the
    embedding in team coordinates), then statically restore blocks to the
    ORIGINAL team's rank order, so the output layout is identical to the
    plain team path (bitwise — pure data movement).  Falls back to the
    plain team ring when no usable topology is attached."""
    view = _team_embed_view(team, topo, embedding, link)
    out = _collect_ring(net, x, axis, team=view)
    if view is team:
        return out
    # view path leaves block t = member with VIEW rank t; original team
    # rank j's member sits at view position view.rank_np[members[j]]
    idx = np.array([view.rank_np[m] for m in team.members])
    return _permute_blocks_static(net, out, idx, team.size, axis)


def _collect_ring_embedded(net: NetOps, x, axis: int, order,
                           n_chunks: int = 1):
    """Ring collect over the embedding order: run the team-relative ring
    in snake coordinates (every hop one physical hop), then restore PE
    block order with one static block permutation.  Pure data movement —
    bitwise identical to the logical ring's output; chunks pipeline like
    the logical ring (the embedding team covers the world)."""
    n = len(order)
    emb_team = _embedding_team(order, n)
    out = _collect_ring(net, x, axis, n_chunks=n_chunks, team=emb_team)
    # team path leaves block t = PE order[t]'s data; PE j's block sits at
    # position rank_np[j]
    return _permute_blocks_static(net, out, emb_team.rank_np, n, axis)


def _fcollect_rd(net: NetOps, x, axis: int, n_chunks: int = 1, team=None):
    rank, n, lift, mask = _team_view(net, team)
    buf = _place_blocks(net, x, rank, n, axis)
    stages = fcollect_schedule(n, _payload_bytes(net, x), "rd").stages
    if team is not None:
        for st in stages:
            buf = buf + net.ppermute(buf, lift(st.pattern))
        return _mask_out(net, mask, buf)
    if n_chunks > 1:
        # every stage is elementwise (ppermute + add of disjoint regions),
        # so pipelining slices the filled output buffer directly
        pieces, _, restore = _flat_pieces(net, buf, n_chunks)

        def stage(c, k, b):
            return b + net.ppermute(b, stages[k].pattern)

        return restore(_software_pipeline(pieces, len(stages), stage))
    for st in stages:
        recv = net.ppermute(buf, st.pattern)
        buf = buf + recv  # disjoint filled regions, zeros elsewhere
    return buf


# Ring collectives use a STATIC schedule: every PE-dependent block index
# is hoisted into one pre- or post-rotation (a single DMA launch), so loop
# bodies contain no per-PE dynamic update at all.  This mirrors how the
# paper's PEs precompute their schedule in shmem_init, and it keeps
# per-stage traffic at one block instead of one full buffer.

def _collect_ring(net: NetOps, x, axis: int, n_chunks: int = 1, team=None):
    rank, n, lift, mask = _team_view(net, team)
    ax = axis + 1
    stages = fcollect_schedule(n, _payload_bytes(net, x), "ring").stages
    # out block i = stacked part (rank - i) mod n
    idx = (rank[:, None] - np.arange(n)) % n
    if team is not None and (n_chunks <= 1 or mask is not None):
        # proper-subset teams run monolithic (§11); covering teams — the
        # embedded ring's coordinate system — fall through and may chunk
        parts = [x]
        cur = x
        for st in stages:
            cur = net.ppermute(cur, lift(st.pattern))
            parts.append(cur)               # part t holds block (rank - t)
        stacked = torch.cat(parts, dim=ax)
        return _mask_out(net, mask, _take_blocks(net, stacked, idx, n, axis))
    if n_chunks > 1:
        # chunk WITHIN the per-PE block along `axis` so each piece runs the
        # identical ring; block order is restored piece-wise and the full
        # blocks reassembled by interleaving
        bounds = _chunk_bounds(x.shape[ax], n_chunks)
        pieces = [[_slice_axis(x, lo, hi, ax)] for lo, hi in bounds]

        def stage(c, k, parts):
            return parts + [net.ppermute(parts[-1], lift(stages[k].pattern))]

        outs = []
        for parts in _software_pipeline(pieces, len(stages), stage):
            stacked_c = torch.cat(parts, dim=ax)
            outs.append(_take_blocks(net, stacked_c, idx, n, axis))
        return _interleave_blocks(outs, bounds, n, ax)
    parts = [x]
    cur = x
    for st in stages:
        cur = net.ppermute(cur, st.pattern)
        parts.append(cur)                   # part t holds block (pe - t)
    stacked = torch.cat(parts, dim=ax)
    return _take_blocks(net, stacked, idx, n, axis)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _combine(op: str) -> Callable:
    """The stage combine of `op`: the reduce_combine kernel on CUDA
    tensors, its plain version on CPU tensors."""
    def fn(a, b):
        return _rc.reduce_combine([a, b], op)
    fn.__name__ = f"combine_{op}"
    return fn


OPS: dict[str, Callable] = {
    "sum": _combine("sum"),
    "prod": _combine("prod"),
    "max": _combine("max"),
    "min": _combine("min"),
    "and": torch.bitwise_and,
    "or": torch.bitwise_or,
    "xor": torch.bitwise_xor,
}


RING_BYTES_THRESHOLD = 1 << 20   # 1 MiB: the old hand-tuned switch point,
                                 # kept as a reference for tests/benches;
                                 # "auto" now prices schedules instead.


def allreduce(net: NetOps, x, op: str = "sum", combine: Callable | None = None,
              algorithm: str | None = None, topo=None, link=None,
              pipeline_chunks=None, team=None, partition=None,
              embedding=None, profile=None, tuner=None):
    """shmem_TYPE_OP_to_all.

    Algorithm selection generalizes the paper's PE-count switch (§3.6:
    dissemination for powers of two, ring otherwise).  "auto" prices the
    candidate schedules with the alpha-beta model on `topo`
    (`choose_algorithm`): recursive doubling moves the FULL buffer log2(N)
    times (alpha-optimal), the ring moves ~2x the buffer total
    (bandwidth-optimal), so large payloads take the ring even at
    power-of-two PE counts.  Explicit "rd"/"ring" override; "hier" runs
    the hierarchical two-level schedule over `partition` (DESIGN.md §11),
    and "auto" prices it as a candidate whenever a partition is given.

    `team` scopes the reduction to a Team (members reduce among
    themselves; non-members pass x through unchanged) or runs every team
    of a TeamPartition concurrently; team execution is monolithic.

    `pipeline_chunks` > 1 executes the chosen schedule chunked and
    double-buffered (bit-identical to monolithic; DESIGN.md §10);
    "auto" for BOTH knobs prices every (algorithm, chunk-count) pair
    (`choose_schedule`) and runs the cheapest.

    `embedding` ("auto" / "snake" / an explicit rank order) enables the
    MESH-EMBEDDED ring (DESIGN.md §12): the same ring algorithm run in
    snake coordinates, so every stage is one physical hop and (meshes
    with a Hamiltonian cycle) no two flows share a link.  It joins the
    "auto" candidate set as "ring_emb" and re-coordinates default-policy
    rings; results are exact for int dtypes and allclose for floats (the
    ring summation order follows the embedding)."""
    fn = combine or OPS[op]
    nbytes = _payload_bytes(net, x)
    if team is not None:
        if algorithm == "hier" or partition is not None:
            raise ValueError(
                "team= and partition= are mutually exclusive: hier runs "
                "over a world-covering partition=; team-scoped reductions "
                "are flat rd/ring")
        _, n, _, _ = _team_view(net, team)
        if n == 1:
            return x
        if algorithm == "auto":
            algo = choose_algorithm(n, nbytes, topo, link, team=team,
                                    embedding=embedding, tuner=tuner)
        elif algorithm in (None, "paper"):
            algo = "rd" if _is_pow2(n) else "ring"
            if algorithm is None and algo == "ring" and embedding is not None:
                algo = "ring_emb"
        else:
            algo = algorithm
        if profile is not None:
            profile.note(algorithm=algo, collective="allreduce",
                         nbytes=nbytes, n_pes=n)
        if algo == "ring_emb":
            # the embedding in team coordinates: the reordered team IS the
            # embedded ring (same members, snake-adjacent rank order) —
            # also for an explicit algorithm= without the knob, mirroring
            # the flat path's snake default
            return _allreduce_team(
                net, x, fn, "ring",
                _team_embed_view(team, topo, embedding, link))
        return _allreduce_team(net, x, fn, algo, team)
    n = net.n_pes
    if n == 1:
        return x
    if algorithm == "hier":
        if profile is not None:
            profile.note(algorithm="hier", collective="allreduce",
                         nbytes=nbytes, n_pes=n)
        return allreduce_hier(net, x, op, combine=combine,
                              partition=partition, topo=topo, link=link,
                              embedding=embedding)
    emb = _resolve_embedding(embedding, topo, n, link, tuner=tuner)
    if algorithm == "ring_emb" and emb is None:
        # explicit algorithm= without the knob: default to the snake, and
        # resolve BEFORE chunk selection so choose_chunks prices the
        # embedded stages that actually execute
        emb = _resolve_embedding("snake", topo, n, link)
    if algorithm == "auto" and pipeline_chunks == "auto":
        algo, chunks = choose_schedule(n, nbytes, topo, link,
                                       partition=partition, embedding=emb,
                                       tuner=tuner)
    else:
        if algorithm == "auto":
            algo = choose_algorithm(n, nbytes, topo, link,
                                    partition=partition, embedding=emb,
                                    tuner=tuner)
        elif algorithm is None:
            algo = "rd" if _is_pow2(n) else "ring"
            if algo == "ring" and emb is not None:
                algo = "ring_emb"   # default policy + enabled embedding
        else:
            algo = algorithm
        chunks = 1 if algo == "hier" else _resolve_chunks(
            pipeline_chunks,
            allreduce_schedule(n, nbytes, algo, embedding=emb), topo, link,
            tuner, ("allreduce", algo, n, nbytes, topo))
    if profile is not None:
        sched = None if algo == "hier" else allreduce_schedule(
            n, nbytes, algo,
            embedding=emb if algo == "ring_emb" else None)
        profile.note(algorithm=algo, chunks=chunks, schedule=sched,
                     topo=topo, link=link, collective="allreduce",
                     nbytes=nbytes, n_pes=n,
                     embedding=emb if algo == "ring_emb" else None)
    if algo == "hier":
        return allreduce_hier(net, x, op, combine=combine,
                              partition=partition, topo=topo, link=link,
                              embedding=embedding)
    if algo == "ring_emb":
        if emb is None:
            algo = "ring"           # no usable embedding: logical ring
        else:
            emb_team = _embedding_team(emb, n)
            if chunks > 1:
                return _allreduce_ring_pipelined(net, x, fn, chunks,
                                                 team=emb_team)
            rs, info = _reduce_scatter_ring(net, x, fn, team=emb_team)
            return allgather_unpad(net, rs, info, team=emb_team)
    if algo == "rd":
        stages = allreduce_schedule(n, nbytes, "rd").stages
        if chunks > 1:
            return tree_map(
                lambda v: _allreduce_rd_pipelined(net, v, fn, stages, chunks),
                x)
        for st in stages:
            recv = net.ppermute(x, st.pattern)
            x = tree_map(fn, x, recv)
        return x
    if chunks > 1:
        return _allreduce_ring_pipelined(net, x, fn, chunks)
    rs, shape_info = _reduce_scatter_ring(net, x, fn)
    return allgather_unpad(net, rs, shape_info)


def _allreduce_team(net: NetOps, x, fn, algo: str, team):
    """Team-scoped allreduce (monolithic): rd runs lifted xor stages with
    the combine applied everywhere (non-members receive zeros and are
    restored by the final mask); ring runs the team-relative
    reduce-scatter + allgather."""
    _, n, lift, mask = _team_view(net, team)
    if algo == "rd":
        out = x
        for st in allreduce_schedule(n, _payload_bytes(net, x), "rd").stages:
            recv = net.ppermute(out, lift(st.pattern))
            out = tree_map(fn, out, recv)
    else:
        rs, info = _reduce_scatter_ring(net, x, fn, team=team)
        out = allgather_unpad(net, rs, info, team=team)
    return _mask_out(net, mask, out, keep=x)


def _allreduce_rd_pipelined(net: NetOps, x, fn, stages, n_chunks: int):
    """Recursive doubling is elementwise per stage (ppermute + combine), so
    pipelining slices the flat payload directly."""
    pieces, _, restore = _flat_pieces(net, x, n_chunks)

    def stage(c, k, buf):
        return fn(buf, net.ppermute(buf, stages[k].pattern))

    return restore(_software_pipeline(pieces, len(stages), stage))


def _flatpad(x, padded: int):
    """Each PE's payload flattened and zero-padded to `padded` elements:
    (n_pes, padded)."""
    flat = x.reshape(x.shape[0], -1)
    pad = padded - flat.shape[1]
    if pad:
        flat = torch.cat([flat, flat.new_zeros((flat.shape[0], pad))], 1)
    return flat


def _allreduce_ring_pipelined(net: NetOps, x, fn, n_chunks: int, team=None):
    """Ring reduce-scatter + allgather, chunked WITHIN the owned 1/n block
    so every element keeps its monolithic block index — and therefore its
    exact reduction order (bit-identical to the eager path).  The fused
    pipeline lets chunk i's allgather stages overlap chunk i+1's
    reduce-scatter stages.

    `team` must be a WORLD-COVERING team (an embedding): the ring then
    runs in its rank coordinates — the mesh-embedded pipelined allreduce
    — with patterns lifted to the world flows that execute."""
    rank, n, lift, mask = _team_view(net, team)
    if mask is not None:
        raise ValueError("the pipelined ring needs a world-covering group")
    orig_shape = tuple(x.shape[1:])
    size = math.prod(orig_shape)
    chunk = -(-size // n)
    padded = chunk * n
    buf = _flatpad(x, padded)
    idx = (rank[:, None] + np.arange(n)) % n
    r = _take_blocks(net, buf, idx, n, 0)

    nbytes = _payload_bytes(net, x)
    rs = reduce_scatter_schedule(n, nbytes).stages
    ag = allgather_schedule(n, float(padded * buf.element_size())).stages
    bounds = _chunk_bounds(chunk, n_chunks)

    def piece_of(t: int, lo: int, hi: int):
        base = t * chunk
        return r[:, base + lo:base + hi]

    def stage(c, k, state):
        lo, hi = bounds[c]
        cur, parts = state
        if k < len(rs):
            j = k + 1
            cur = net.ppermute(cur, lift(rs[k].pattern))
            cur = fn(piece_of(n - j, lo, hi), cur)
            return (cur, (cur,) if k == len(rs) - 1 else parts)
        cur = net.ppermute(cur, lift(ag[k - len(rs)].pattern))
        return (cur, parts + (cur,))

    init = [(piece_of(0, lo, hi), ()) for lo, hi in bounds]
    finals = _software_pipeline(init, len(rs) + len(ag), stage)
    idx2 = (rank[:, None] + 1 - np.arange(n)) % n
    outs = []
    for _, parts in finals:
        stacked_c = torch.cat(parts, dim=-1)
        outs.append(_take_blocks(net, stacked_c, idx2, n, 0))
    out = _interleave_blocks(outs, bounds, n, -1)
    return out[:, :size].reshape((x.shape[0],) + orig_shape)


def reduce_scatter(net: NetOps, x, op: str = "sum",
                   combine: Callable | None = None, team=None, profile=None):
    """Ring reduce-scatter; returns this PE's owned chunk of the flattened,
    padded array plus the info needed to allgather/unpad it.  With `team`
    the ring runs in team coordinates (a TeamPartition runs every team's
    ring concurrently); chunk ownership is by team rank."""
    fn = combine or OPS[op]
    if profile is not None:
        nbytes = _payload_bytes(net, x)
        profile.note(algorithm="ring",
                     schedule=reduce_scatter_schedule(net.n_pes, nbytes),
                     collective="reduce_scatter", nbytes=nbytes,
                     n_pes=net.n_pes)
    return _reduce_scatter_ring(net, x, fn, team=team)


def _reduce_scatter_parts(net: NetOps, x, fn, team=None):
    """The ring reduce-scatter of `_reduce_scatter_ring` with the FINAL
    combine left undone: runs all n-1 ring stages but returns the last
    stage's two operands separately instead of `fn`-combining them, so a
    fused consumer (the fused reduce-scatter + AdamW update) can land
    that combine inside its own kernel (DESIGN.md §14).

    Returns ``(local_last, incoming, info, mask)``: the owned chunk is
    ``fn(local_last, incoming)`` (``incoming`` is None when n == 1 and
    ``local_last`` is already final).  `info`/`mask` as in
    `_reduce_scatter_ring`; callers must apply `_mask_out(net, mask, ...)`
    to whatever they derive from the chunk."""
    rank, n, lift, mask = _team_view(net, team)
    orig_shape = tuple(x.shape[1:])
    size = math.prod(orig_shape)
    chunk = -(-size // n)
    padded = chunk * n
    buf = _flatpad(x, padded)
    idx = (rank[:, None] + np.arange(n)) % n
    r = _take_blocks(net, buf, idx, n, 0)

    def static_chunk(b, t):
        return b[:, t * chunk:(t + 1) * chunk]

    # rank p ends up owning the fully-reduced chunk (p + 1) % n
    own_idx = (rank + 1) % n
    info = (orig_shape, size, chunk, own_idx)
    cur = static_chunk(r, 0)                     # chunk[rank]
    if n == 1:
        return cur, None, info, mask
    sched = reduce_scatter_schedule(n, _payload_bytes(net, x))
    for j, st in enumerate(sched.stages[:-1], start=1):
        cur = net.ppermute(cur, lift(st.pattern))
        cur = fn(static_chunk(r, n - j), cur)    # chunk[(rank - j) mod n]
    incoming = net.ppermute(cur, lift(sched.stages[-1].pattern))
    return static_chunk(r, 1), incoming, info, mask


def _reduce_scatter_ring(net: NetOps, x, fn, team=None):
    """Ring reduce-scatter with the static schedule: one pre-rotation
    puts every stage's chunk at a STATIC offset, so the loop body is free
    of per-PE slicing (r block t = chunk (rank + t) mod n).  `rank` is
    the group rank of the `team` view (the PE id for the world);
    non-members of a proper-subset team get a zero chunk."""
    local, incoming, info, mask = _reduce_scatter_parts(net, x, fn,
                                                        team=team)
    cur = local if incoming is None else fn(local, incoming)
    return _mask_out(net, mask, cur), info


def allgather_unpad(net: NetOps, chunk_val, info, team=None):
    """Ring allgather of a `reduce_scatter` result, undoing its flatten/pad.

    `info` is the handle `reduce_scatter` returned alongside the owned
    chunk: ``(orig_shape, size, chunk, own_idx)``.  Static schedule: parts
    arrive in ring order; one post-gather restores block order, then the
    padding is stripped and the original shape restored.  Composing
    ``allgather_unpad(net, *reduce_scatter(net, x))`` is the
    bandwidth-optimal ring allreduce (~2x payload on the wire vs log2(N)x
    for recursive doubling) — the ZeRO-style gradient-sync building block
    (DESIGN.md §8).  Pass the same `team` the reduce-scatter ran with;
    non-members of a proper-subset team read zeros."""
    orig_shape, size, chunk, own_idx = info
    rank, n, lift, mask = _team_view(net, team)
    nbytes = float(chunk * n * chunk_val.element_size())
    parts = [chunk_val]                 # part t = chunk (rank + 1 - t) mod n
    cur = chunk_val
    for st in allgather_schedule(n, nbytes).stages:
        cur = net.ppermute(cur, lift(st.pattern))
        parts.append(cur)
    stacked = torch.cat(parts, dim=-1)
    # out block i = part (rank + 1 - i) mod n
    idx = (rank[:, None] + 1 - np.arange(n)) % n
    out = _take_blocks(net, stacked, idx, n, 0)
    out = out[:, :size].reshape((out.shape[0],) + tuple(orig_shape))
    return _mask_out(net, mask, out)


# ---------------------------------------------------------------------------
# alltoall (pairwise exchange — paper Fig. 9)
# ---------------------------------------------------------------------------

def alltoall(net: NetOps, x, axis: int = 0, pipeline_chunks=None,
             topo=None, link=None, team=None, profile=None, tuner=None):
    """out[src-block] = x_src[my-block]; x's `axis` dim = group size *
    block (group = the world, or `team`'s members in team-rank order).

    Static schedule: one pre-rotation makes every stage's send block a
    static slice; received parts concatenate in ring order and one
    post-gather restores block order — no per-stage dynamic updates.
    `pipeline_chunks` > 1 chunks each block's payload and pipelines the
    pairwise sends (bit-identical; DESIGN.md §10; team execution is
    monolithic, non-members return zeros)."""
    rank, n, lift, mask = _team_view(net, team)
    if n == 1:
        return x
    ax = axis + 1
    dim = x.shape[ax]
    if dim % n:
        raise ValueError(f"alltoall axis dim {dim} not divisible by n={n}")

    # pre-rotate: r block t = x block (rank + t) mod n
    idx = (rank[:, None] + np.arange(n)) % n
    r = _take_blocks(net, x, idx, n, axis)
    blk = dim // n
    nbytes = _payload_bytes(net, x)
    sched = alltoall_schedule(n, nbytes)
    out_idx = (rank[:, None] - np.arange(n)) % n

    def static_blk(v, t, lo=0, hi=blk):
        return v.narrow(ax, t * blk + lo, hi - lo)

    if team is not None:
        if profile is not None:
            profile.note(algorithm="pairwise", schedule=sched, topo=topo,
                         link=link, collective="alltoall",
                         nbytes=nbytes, n_pes=n)
        parts = [static_blk(r, 0)]
        for j, st in enumerate(sched.stages, start=1):
            parts.append(net.ppermute(static_blk(r, j), lift(st.pattern)))
        stacked = torch.cat(parts, dim=ax)
        return _mask_out(net, mask,
                         _take_blocks(net, stacked, out_idx, n, axis))

    chunks = _resolve_chunks(pipeline_chunks, sched, topo, link, tuner,
                             ("alltoall", "pairwise", n, nbytes, topo))
    if profile is not None:
        profile.note(algorithm="pairwise", chunks=chunks, schedule=sched,
                     topo=topo, link=link, collective="alltoall",
                     nbytes=nbytes, n_pes=n)
    if chunks > 1:
        bounds = _chunk_bounds(blk, chunks)

        def stage(c, k, parts):
            lo, hi = bounds[c]
            st = sched.stages[k]
            return parts + (net.ppermute(static_blk(r, k + 1, lo, hi),
                                         st.pattern),)

        init = [(static_blk(r, 0, lo, hi),) for lo, hi in bounds]
        outs = []
        for parts in _software_pipeline(init, len(sched.stages), stage):
            stacked_c = torch.cat(parts, dim=ax)
            outs.append(_take_blocks(net, stacked_c, out_idx, n, axis))
        return _interleave_blocks(outs, bounds, n, ax)

    parts = [static_blk(r, 0)]          # own block: out[pe] = x_pe[pe]
    for j, st in enumerate(sched.stages, start=1):
        recv = net.ppermute(static_blk(r, j), st.pattern)
        parts.append(recv)              # part t = out-block (pe - t) mod n
    stacked = torch.cat(parts, dim=ax)
    return _take_blocks(net, stacked, out_idx, n, axis)


# ---------------------------------------------------------------------------
# point-to-point RMA
# ---------------------------------------------------------------------------

def put(net: NetOps, x, pattern: Sequence[tuple[int, int]]):
    """One-sided put along a static (src, dst) pattern; PEs not receiving
    keep zeros (use shmem.put for merge-with-local semantics)."""
    return net.ppermute(x, pattern)


def get(net: NetOps, x, pattern: Sequence[tuple[int, int]]):
    """get along (requester, owner) pairs: owner pushes — the IPI-get.
    The inverse pairs are compiled directly so fan-out reads (many
    requesters naming one owner) validate against the executed pattern."""
    if isinstance(pattern, CommPattern):
        return net.ppermute(x, pattern.inverse)
    return net.ppermute(x, [(o, r) for r, o in pattern])


# ---------------------------------------------------------------------------
# scans (substrate for atomics)
# ---------------------------------------------------------------------------

_SCAN_IDENTITY = {"sum": 0, "prod": 1, "max": None, "min": None,
                  "and": -1, "or": 0, "xor": 0}


def exclusive_scan(net: NetOps, x, op: str = "sum"):
    """Exclusive scan over the PE axis of a per-PE scalar/array.

    This realizes the observable semantics of concurrent shmem atomics in
    PE order (DESIGN.md §6): fetch_add's return on PE i = init + sum of
    contributions of PEs < i."""
    n = net.n_pes
    identity = _SCAN_IDENTITY[op]
    all_vals = fcollect(net, x.unsqueeze(1), axis=0)    # (n_pes, n, ...)
    below = np.arange(n)[None, :] < np.arange(n)[:, None]
    mask = device_table(below, all_vals.device).reshape(
        (n, n) + (1,) * (all_vals.dim() - 2))
    dt = all_vals.dtype
    if identity is None:        # max/min: mask with the dtype's extremes
        info = torch.finfo(dt)
        fill = torch.tensor(info.min if op == "max" else info.max, dtype=dt,
                            device=all_vals.device)
        masked = torch.where(mask, all_vals, fill)
        return masked.amax(1) if op == "max" else masked.amin(1)
    masked = torch.where(mask, all_vals,
                         torch.tensor(identity, dtype=dt,
                                      device=all_vals.device))
    if op == "sum":
        return masked.sum(1, dtype=dt)
    if op == "prod":
        return masked.prod(1, dtype=dt)
    fn = OPS[op]
    red = masked[:, 0]
    for k in range(1, n):
        red = fn(red, masked[:, k])
    return red
