"""Elastic restart for a degraded mesh (DESIGN.md §17); port of
`repro/core/elastic.py`.

When a PE dies mid-run the OpenSHMEM 1.3 answer is a hang at the next
barrier; this module is the beyond-spec recovery path the fault layer
(:mod:`repro_torch.core.fault`) makes possible:

  1. :func:`degrade` rebuilds the communication structure for the LIVE
     PEs — a :class:`~repro_torch.core.team.Team` whose member order is a
     congestion-optimized ring embedding of the survivors (the analogue
     of re-running the snake embedding on a 4x4 mesh with a hole), and a
     degraded-mesh :func:`~repro_torch.core.tuner.fingerprint` so the
     :class:`~repro_torch.core.tuner.TunedSelector` re-tunes instead of
     replaying full-mesh winners.
  2. :func:`recover` drives the whole protocol on a live context:
     re-fingerprint, restore the last complete checkpoint (global
     arrays, so resharding onto fewer PEs falls out of
     ``manager.restore``) into the template's devices, and report
     recovery wall time to the attached profiler.

The ring optimization deliberately does NOT reuse
``collectives.optimize_embedding``: that returns a WORLD-wide
permutation and could relabel a live PE onto a dead one.  Here the
search space is orderings of the live set only — a pairwise-swap hill
climb over (max link load, total weighted hops) of the live ring under
the topology's XY routes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

from . import fault as fault_mod
from . import team as team_mod
from . import tuner as tuner_mod
from .topology import MeshTopology


@dataclasses.dataclass(frozen=True)
class DegradedMesh:
    """The rebuilt communication structure for the surviving PEs.

    topo        : the PHYSICAL mesh (unchanged — dead PEs still occupy
                  coordinates; routes must simply avoid addressing them)
    dead        : the dead world PEs, sorted
    live        : the surviving world PEs, in ring-embedded order — the
                  embedding collectives over `team` should use
    team        : interned Team over `live` (members in ring order, so
                  team-rank ring algorithms take mesh-local hops)
    fingerprint : the degraded-mesh tuning key
                  (:func:`repro_torch.core.tuner.fingerprint` with dead_pes)
    """

    topo: MeshTopology | None
    dead: tuple[int, ...]
    live: tuple[int, ...]
    team: team_mod.Team
    fingerprint: str

    @property
    def n_live(self) -> int:
        return len(self.live)


def _ring_cost(topo: MeshTopology, order: Sequence[int]
               ) -> tuple[float, float]:
    """(max link load, total weighted hops) of the ring over `order`
    under XY routing — the same objective the snake-embedding scorer
    uses, restricted to the live ring."""
    loads: dict[tuple[int, int], float] = {}
    hops = 0.0
    for i, pe in enumerate(order):
        dst = order[(i + 1) % len(order)]
        if dst == pe:
            continue
        for u, v in topo.route(pe, dst):
            key = (u, v) if u < v else (v, u)
            loads[key] = loads.get(key, 0.0) + 1.0
            hops += topo.link_weight(u, v)
    return (max(loads.values()) if loads else 0.0, hops)


def _optimize_live_ring(topo: MeshTopology, live: Sequence[int]
                        ) -> tuple[int, ...]:
    """Ring order over the LIVE PEs: seed with the snake order filtered
    to survivors (already near-optimal — a dead PE just shortens the
    snake), then pairwise-swap hill climb until no swap improves
    (max link load, total hops).  Deterministic: first-improvement scan
    in index order."""
    order = [p for p in topo.snake_order() if p in set(live)]
    if len(order) <= 3:
        return tuple(order)
    cost = _ring_cost(topo, order)
    improved = True
    while improved:
        improved = False
        for i in range(len(order) - 1):
            for j in range(i + 1, len(order)):
                order[i], order[j] = order[j], order[i]
                c = _ring_cost(topo, order)
                if c < cost:
                    cost = c
                    improved = True
                else:
                    order[i], order[j] = order[j], order[i]
    return tuple(order)


def degrade(topo: MeshTopology | None, dead_pes: Sequence[int],
            world_n: int | None = None) -> DegradedMesh:
    """Rebuild teams/embedding/fingerprint for the mesh minus
    `dead_pes`.  With no topology (flat PE space) the live ring is just
    the surviving ranks in order."""
    n = world_n if world_n is not None \
        else (topo.n_pes if topo is not None else None)
    if n is None:
        raise ValueError("degrade() needs topo or world_n")
    dead = tuple(sorted({int(p) % n for p in dead_pes}))
    live_set = [p for p in range(n) if p not in dead]
    if not live_set:
        raise ValueError("every PE is dead — nothing to degrade to")
    if topo is not None and getattr(topo, "n_pes", None) == n:
        live = _optimize_live_ring(topo, live_set)
    else:
        live = tuple(live_set)
    return DegradedMesh(
        topo=topo, dead=dead, live=live,
        team=team_mod.make_team(live, n),
        fingerprint=tuner_mod.fingerprint(topo, n, dead_pes=dead))


def recover(ctx, dead_pes: Sequence[int], ckpt_dir, template,
            shardings=None) -> tuple[int, object, DegradedMesh]:
    """The elastic restart protocol on a live
    :class:`~repro_torch.core.shmem.ShmemContext`:

      1. rebuild the degraded-mesh structure (:func:`degrade`),
      2. re-key the context's tuning identity
         (``ctx.refingerprint``) so the TunedSelector re-tunes,
      3. restore the last COMPLETE checkpoint
         (:func:`repro_torch.ckpt.manager.restore` — global arrays,
         resharded where a saved shape differs, on the template's
         devices; with `shardings`, a spec tree, called in a rank
         process, each leaf cut to the rank's block of it).

    Returns ``(step, state, degraded)``.  Recovery wall time lands on
    the attached profiler as ``fault.recovery_us`` plus an ``instant``
    trace event, so ``tracereport`` shows it for chaos runs."""
    from ..ckpt import manager as ckpt_mod

    t0 = time.perf_counter()
    dm = degrade(ctx.topo, dead_pes, world_n=ctx.n_pes)
    ctx.refingerprint(dm.fingerprint)
    step, state = ckpt_mod.restore(ckpt_dir, template, shardings=shardings)
    wall = time.perf_counter() - t0
    prof = ctx._active_profile()
    if prof is not None:
        prof.count("fault.recovery_us", int(wall * 1e6))
    fault_mod.fault_event(prof, "fault.recovered",
                          dead=list(dm.dead), step=step,
                          recovery_us=int(wall * 1e6))
    return step, state, dm


__all__ = ["DegradedMesh", "degrade", "recover"]
