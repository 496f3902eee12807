"""The port's host-side runtime layer against the JAX package's, exactly:
topology (coords, hops, routes, snake orders), the alpha-beta model,
compiled patterns (pairs, masks, inverse, hops, link loads, link waves),
teams and partitions (lifts, complements, topology views), every schedule
builder's stage costs, every `choose_*` pick over a grid of (n, nbytes,
topo), and the 12 paper-fidelity values of `benchmarks/paper_fidelity.py`
derived through the port's modules.  Mirrors test_topology_abmodel.py,
test_pattern.py, test_team.py and the route/wave parts of
test_congestion.py."""
import dataclasses
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import paper_fidelity as fid  # noqa: E402
from repro.core import abmodel as jab  # noqa: E402
from repro.core import collectives as jcoll  # noqa: E402
from repro.core import pattern as jpat  # noqa: E402
from repro.core import team as jteam  # noqa: E402
from repro.core import topology as jtop  # noqa: E402
from repro.core import tuner as jtuner  # noqa: E402
from repro_torch.configs import epiphany16 as paper  # noqa: E402
from repro_torch.core import abmodel as ab  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core import pattern as pat  # noqa: E402
from repro_torch.core import team as team_mod  # noqa: E402
from repro_torch.core import topology as top  # noqa: E402
from repro_torch.core import tuner as tuner_mod  # noqa: E402

TOPOS = [top.epiphany3(), top.MeshTopology((3, 5), (False, False)),
         top.MeshTopology((2, 7), (False, False)),
         top.MeshTopology((1, 8), (False, False)),
         top.MeshTopology((4, 4)), top.MeshTopology((2, 2, 3), (False, True,
                                                                True),
                                                    (10.0, 1.0, 1.0))]
IDS = ["4x4", "3x5", "2x7", "1x8", "4x4torus", "2x2x3pod"]


def jtopo(t):
    return None if t is None else jtop.MeshTopology(t.shape, t.torus,
                                                    t.link_cost)


def jlink(link):
    return None if link is None else jab.LinkModel(**dataclasses.asdict(link))


def jteam_of(t):
    if isinstance(t, team_mod.TeamPartition):
        return jteam.TeamPartition([jteam_of(m) for m in t.teams])
    return jteam.make_team(t.members, t.world_n)


def jpattern(p):
    return jpat.compile_pattern(p.pairs, p.n_pes)


def same_pattern(p, jp):
    assert p.pairs == jp.pairs and p.n_pes == jp.n_pes
    for a in ("dst_mask", "src_mask", "src_for_dst"):
        np.testing.assert_array_equal(getattr(p, a), getattr(jp, a))


def same_schedule(s, js, topo=None):
    assert len(s) == len(js)
    for st, jst in zip(s.stages, js.stages):
        same_pattern(st.pattern, jst.pattern)
        assert st.nbytes == jst.nbytes
    assert s.cost(topo) == js.cost(jtopo(topo))


# ---------------------------------------------------------------------------
# topology and the alpha-beta model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo", TOPOS, ids=IDS)
def test_topology_matches(topo):
    jt = jtopo(topo)
    n = topo.n_pes
    assert topo.max_hops() == jt.max_hops()
    assert topo.snake_order() == jt.snake_order()
    for a in range(n):
        assert topo.coords(a) == jt.coords(a)
        assert topo.farthest_first(a, range(n)) == jt.farthest_first(a,
                                                                     range(n))
        for b in range(n):
            assert topo.hops(a, b) == jt.hops(a, b)
            assert topo.route(a, b) == jt.route(a, b)
            assert topo.route_alt(a, b) == jt.route_alt(a, b)
    for f in ("epiphany3", "v5e_pod"):
        assert dataclasses.astuple(getattr(top, f)()) == \
            dataclasses.astuple(getattr(jtop, f)())
    assert dataclasses.astuple(top.v5e_multipod(3)) == \
        dataclasses.astuple(jtop.v5e_multipod(3))


def test_abmodel_matches():
    for name in ("ICI_V5E", "DCN", "EPIPHANY_NOC", "EPIPHANY_NOC_GET"):
        assert dataclasses.astuple(getattr(ab, name)) == \
            dataclasses.astuple(getattr(jab, name))
    rng = np.random.RandomState(0)
    sizes = [8 << i for i in range(12)]
    times = [1e-7 + s / 2.4e9 + rng.rand() * 1e-9 for s in sizes]
    assert dataclasses.astuple(ab.fit(sizes, times)) == \
        dataclasses.astuple(jab.fit(sizes, times))
    loads = [1, 1, 2, 3, 4]
    ts = [1.0, 1.0, 1.6, 2.3, 2.8]
    assert ab.fit_contention(loads, ts) == jab.fit_contention(loads, ts)
    stages = [(4096.0, 2.0, 3.0), (512.0, 1.0), (64.0, 3.0, 1.0)]
    for link in (ab.EPIPHANY_NOC, ab.ICI_V5E):
        jl = jlink(link)
        assert ab.modeled_collective_time(stages, link) == \
            jab.modeled_collective_time(stages, jl)
        assert ab.modeled_overlapped_time(stages, 1e-6, link) == \
            jab.modeled_overlapped_time(stages, 1e-6, jl)
        for c in (1, 2, 8):
            assert ab.modeled_pipelined_time(stages, c, link) == \
                jab.modeled_pipelined_time(stages, c, jl)
        assert ab.choose_chunks(stages, link) == jab.choose_chunks(stages,
                                                                   jl)
    for bad in (([8], [1.0]), ([8, 8], [1.0, 2.0])):
        with pytest.raises(ValueError):
            ab.fit(*bad)
    # the measured chunk count wins on a hit within the cap; a miss (or
    # no key, or a measured count above the cap) takes the model's, in
    # both packages alike
    db, jdb = tuner_mod.TuningDB(), jtuner.TuningDB()
    for d in (db, jdb):
        d.record("flat:n8", "allreduce", "n8", 4096, "ring", 16, None, 1e-6)
    sel, jsel = tuner_mod.TunedSelector(db), jtuner.TunedSelector(jdb)
    for key in (("allreduce", "ring", 8, 4096, None),
                ("allreduce", "rd", 8, 4096, None), None):
        for mc in (32, 4):
            assert ab.choose_chunks(stages, max_chunks=mc, tuner=sel,
                                    key=key) == \
                jab.choose_chunks(stages, max_chunks=mc, tuner=jsel, key=key)
    assert ab.choose_chunks(stages, max_chunks=32, tuner=sel, key=(
        "allreduce", "ring", 8, 4096, None)) == 16


# ---------------------------------------------------------------------------
# compiled patterns
# ---------------------------------------------------------------------------

def _patterns(n):
    yield pat.ring_pattern(n)
    yield pat.ring_pattern(n, n // 2 or 1)
    yield pat.binomial_stage_pattern(n, 1, root=n - 1)
    yield pat.compile_pattern([(0, n - 1)], n)
    yield pat.compile_pattern([(s, (3 * s + 1) % n) for s in range(n)
                               if len({(3 * t + 1) % n for t in range(n)})
                               == n], n)
    if n & (n - 1) == 0:
        yield pat.xor_pattern(n, n // 2)


@pytest.mark.parametrize("topo", TOPOS, ids=IDS)
def test_patterns_match(topo):
    n = topo.n_pes
    jt = jtopo(topo)
    for p in _patterns(n):
        jp = jpattern(p)
        same_pattern(p, jp)
        same_pattern(p.inverse, jp.inverse)
        assert p.inverse.inverse is p
        np.testing.assert_array_equal(p.pair_hops(topo), jp.pair_hops(jt))
        assert p.max_hops(topo) == jp.max_hops(jt)
        assert p.total_hops(topo) == jp.total_hops(jt)
        assert p.link_loads(topo) == jp.link_loads(jt)
        assert p.max_link_load(topo) == jp.max_link_load(jt)
        assert p.max_link_load(None) == jp.max_link_load(None)
        waves, jwaves = p.link_waves(topo), jp.link_waves(jt)
        assert len(waves) == len(jwaves)
        for w, jw in zip(waves, jwaves):
            same_pattern(w, jw)
        rl = p.relabel(topo.snake_order(), n)
        same_pattern(rl, jp.relabel(jt.snake_order(), n))
        table = p.gather_table_device("cpu")
        assert table.dtype == torch.int32
        np.testing.assert_array_equal(table.numpy(), jp.src_for_dst)
        assert p.gather_table_device("cpu") is table


def test_pattern_interning_and_validation():
    ring = [(i, (i + 1) % 16) for i in range(16)]
    p = pat.compile_pattern(ring, 16)
    assert p is pat.compile_pattern(list(reversed(ring)), 16)
    assert p is pat.ring_pattern(16) and pat.as_pattern(p, 16) is p
    with pytest.raises(TypeError):
        pat.CommPattern(((0, 1),), 4)
    with pytest.raises(ValueError):
        pat.compile_pattern([(0, 2), (1, 2)], 4)
    with pytest.raises(ValueError):
        pat.as_pattern(p, 17)


# ---------------------------------------------------------------------------
# teams
# ---------------------------------------------------------------------------

def test_teams_match():
    n = 16
    topo = top.epiphany3()
    world = team_mod.team_world(n)
    teams = [world, team_mod.split_strided(world, 1, 3, 5),
             team_mod.from_active_set(2, 1, 4, n),
             team_mod.make_team((9, 2, 14, 7), n)]
    for t in teams:
        jt = jteam_of(t)
        np.testing.assert_array_equal(t.rank_np, jt.rank_np)
        np.testing.assert_array_equal(t.member_np, jt.member_np)
        assert [t.translate(pe) for pe in range(-1, n + 1)] == \
            [jt.translate(pe) for pe in range(-1, n + 1)]
        for p in (pat.ring_pattern(t.size), pat.ring_pattern(t.size, 2 %
                                                            t.size or 1)):
            same_pattern(t.lift(p), jt.lift(jpattern(p)))
        tv, jtv = t.topo_view(topo), jt.topo_view(jtopo(topo))
        for a in range(t.size):
            for b in range(t.size):
                assert tv.hops(a, b) == jtv.hops(a, b)
                assert tv.route(a, b) == jtv.route(a, b)
        same_schedule(t.lift_schedule(coll.barrier_schedule(t.size)),
                      jt.lift_schedule(jcoll.barrier_schedule(t.size)), topo)
    for axis in (-1, 0):
        part = team_mod.split_2d(world, topo, axis)
        jpart = jteam.split_2d(jteam.team_world(n), jtopo(topo), axis)
        assert [m.members for m in part.teams] == \
            [m.members for m in jpart.teams]
        assert [m.members for m in part.complement().teams] == \
            [m.members for m in jpart.complement().teams]
        np.testing.assert_array_equal(part.team_id_np, jpart.team_id_np)
        same_pattern(part.lift(pat.ring_pattern(4)),
                     jpart.lift(jpat.ring_pattern(4)))
    for bad in ([], [0, 0], [16]):
        with pytest.raises(ValueError):
            team_mod.make_team(bad, n)


# ---------------------------------------------------------------------------
# schedules and the cost-model selectors
# ---------------------------------------------------------------------------

NBYTES = [8.0, 256.0, 4096.0, float(1 << 16), float(1 << 20),
          float(1 << 24)]
LINKS = [None, ab.EPIPHANY_NOC, ab.ICI_V5E]


@pytest.mark.parametrize("topo", TOPOS, ids=IDS)
def test_schedule_costs_match(topo):
    n = topo.n_pes
    for nb in (0.0, 100.0, 4096.0):
        same_schedule(coll.broadcast_schedule(n, nb, root=n // 3),
                      jcoll.broadcast_schedule(n, nb, root=n // 3), topo)
        same_schedule(coll.alltoall_schedule(n, nb * n),
                      jcoll.alltoall_schedule(n, nb * n), topo)
        same_schedule(coll.reduce_scatter_schedule(n, nb),
                      jcoll.reduce_scatter_schedule(n, nb), topo)
        same_schedule(coll.allgather_schedule(n, nb),
                      jcoll.allgather_schedule(n, nb), topo)
        for algo in ("ring", "ring_emb") + (("rd",) if n & (n - 1) == 0
                                            else ()):
            emb = topo.snake_order() if algo == "ring_emb" else None
            same_schedule(coll.allreduce_schedule(n, nb, algo, emb),
                          jcoll.allreduce_schedule(n, nb, algo, emb), topo)
            same_schedule(coll.fcollect_schedule(n, nb, algo, emb),
                          jcoll.fcollect_schedule(n, nb, algo, emb), topo)
            assert coll.allreduce_stages(n, nb, topo, algo if emb is None
                                         else "ring") == \
                jcoll.allreduce_stages(n, nb, jtopo(topo), algo if emb is None
                                       else "ring")
        for algo in ("dissem", "tree"):
            same_schedule(coll.barrier_schedule(n, algo),
                          jcoll.barrier_schedule(n, algo), topo)
        jt = jtopo(topo)
        assert coll.barrier_stages(n, topo) == jcoll.barrier_stages(n, jt)
        assert coll.broadcast_stages(n, nb, topo) == \
            jcoll.broadcast_stages(n, nb, jt)
        assert coll.fcollect_stages(n, nb, topo) == \
            jcoll.fcollect_stages(n, nb, jt)
        assert coll.alltoall_stages(n, nb, topo) == \
            jcoll.alltoall_stages(n, nb, jt)
    if len(topo.shape) == 2 and topo.shape[0] > 1:
        part = team_mod.split_2d(team_mod.team_world(n), topo, -1)
        jpart = jteam_of(part)
        for emb in (None, "snake"):
            same_schedule(
                coll.allreduce_hier_schedule(part, 4096.0, topo=topo,
                                             link=ab.EPIPHANY_NOC,
                                             embedding=emb),
                jcoll.allreduce_hier_schedule(jpart, 4096.0, topo=jtopo(topo),
                                              link=jab.EPIPHANY_NOC,
                                              embedding=emb), topo)


@pytest.mark.parametrize("topo", TOPOS + [None], ids=IDS + ["flat"])
def test_choose_picks_match(topo):
    n = topo.n_pes if topo is not None else 12
    jt = jtopo(topo)
    part = jpart = None
    if topo is not None and len(topo.shape) == 2 and topo.shape[0] > 1:
        part = team_mod.split_2d(team_mod.team_world(n), topo, -1)
        jpart = jteam_of(part)
    t = team_mod.split_strided(team_mod.team_world(n), 0, 2, n // 2)
    jt_team = jteam_of(t)
    for link in LINKS:
        jl = jlink(link)
        assert coll.choose_barrier(n, topo, link) == \
            jcoll.choose_barrier(n, jt, jl)
        assert coll.choose_barrier(t.size, topo, link, team=t) == \
            jcoll.choose_barrier(t.size, jt, jl, team=jt_team)
        assert coll.choose_embedding(n, topo, link) == \
            jcoll.choose_embedding(n, jt, jl)
        for nb in NBYTES:
            for collective in ("allreduce", "fcollect"):
                for emb in (None, "auto", "snake"):
                    kw = dict(collective=collective, embedding=emb)
                    assert coll.choose_algorithm(n, nb, topo, link, **kw) \
                        == jcoll.choose_algorithm(n, nb, jt, jl, **kw)
                    assert coll.choose_algorithm(
                        n, nb, topo, link, team=t, **kw) == \
                        jcoll.choose_algorithm(n, nb, jt, jl,
                                               team=jt_team, **kw)
                    assert coll.choose_schedule(n, nb, topo, link, **kw) \
                        == jcoll.choose_schedule(n, nb, jt, jl, **kw)
            if part is not None:
                assert coll.choose_algorithm(n, nb, topo, link,
                                             partition=part) == \
                    jcoll.choose_algorithm(n, nb, jt, jl, partition=jpart)
                assert coll.choose_schedule(n, nb, topo, link,
                                            partition=part) == \
                    jcoll.choose_schedule(n, nb, jt, jl, partition=jpart)
    # a measured verdict wins over the model, in both packages alike
    fp = tuner_mod.fingerprint(topo, n)
    db, jdb = tuner_mod.TuningDB(), jtuner.TuningDB()
    for d in (db, jdb):
        d.record(fp, "allreduce", f"n{n}", 64.0, "ring", 2, None, 1e-6)
    sel, jsel = tuner_mod.TunedSelector(db), jtuner.TunedSelector(jdb)
    for nb in (64.0, 1 << 20):
        assert coll.choose_algorithm(n, nb, topo, tuner=sel) == \
            jcoll.choose_algorithm(n, nb, jt, tuner=jsel)
        assert coll.choose_schedule(n, nb, topo, tuner=sel) == \
            jcoll.choose_schedule(n, nb, jt, tuner=jsel)
    assert coll.choose_algorithm(n, 64.0, topo, tuner=sel) == "ring"
    assert coll.choose_schedule(n, 64.0, topo, tuner=sel) == ("ring", 2)


def test_optimize_embedding_matches():
    topo = top.epiphany3()
    sched = coll.allreduce_schedule(16, float(1 << 20), "ring")
    jsched = jcoll.allreduce_schedule(16, float(1 << 20), "ring")
    got, perm = coll.optimize_embedding(sched, topo, ab.EPIPHANY_NOC)
    jgot, jperm = jcoll.optimize_embedding(jsched, jtopo(topo),
                                           jab.EPIPHANY_NOC)
    assert perm == jperm
    same_schedule(got, jgot, topo)
    assert coll.embedding_team("auto", topo, 16, ab.EPIPHANY_NOC).members \
        == jcoll.embedding_team("auto", jtopo(topo), 16,
                                jab.EPIPHANY_NOC).members


# ---------------------------------------------------------------------------
# the paper-fidelity gate through the port's modules
# ---------------------------------------------------------------------------

def test_paper_fidelity_values_exact():
    """Each of the 12 gated rows derived with the port's abmodel,
    collectives and epiphany16 equals the reference derivation exactly."""
    ref = fid.evaluate()
    model = fid.FidelityModel(
        link=paper.PUT_LINK, get_link=paper.GET_LINK, topo=paper.TOPOLOGY,
        n=paper.N_PES, isr_entry_s=paper.ISR_ENTRY_S,
        sizes=tuple(paper.MSG_SIZES))
    with mock.patch.object(fid, "abmodel", ab), \
            mock.patch.object(fid, "coll", coll), \
            mock.patch.object(fid, "paper", paper):
        got = fid.evaluate(model)
    assert len(got) == len(ref) == 12
    for g, r in zip(got, ref):
        assert g.row.key == r.row.key
        assert g.derived == r.derived, g.row.key
        assert g.ok and r.ok
    assert paper.PAPER == fid.paper.PAPER
    assert paper.MSG_SIZES == fid.paper.MSG_SIZES
