"""The port's profiler and measured tuner (`repro_torch.core.profile`,
`repro_torch.core.tuner`) against the JAX package's, on the CPU, on the
same numpy inputs.  Mirrors tests/test_profile_tuner.py (all but its
SPMD test, which needs the multi-device backend).

Compared exactly: every sample field but the times (``wall_s``,
``t_start``, ``issue_s``, ``stall_s``), the counters but ``total_s``,
the profiler document, the TuningDB's best/variants/JSON after the same
records (and each package loading the other's file), the TunedSelector's
answers, ``choose_*`` with a tuner, and ``tune``/``refit_link``
summaries with ``measure`` replaced by one deterministic timer in both
packages.  The real sweep is held to the reference's acceptance
properties on 4 PEs."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Profiler as JProfiler
from repro.core import TunedSelector as JTunedSelector
from repro.core import TuningDB as JTuningDB
from repro.core import Tuner as JTuner
from repro.core import abmodel as jab
from repro.core import collectives as jcoll
from repro.core import epiphany3 as jepiphany3
from repro.core import fusion as jfusion
from repro.core import profile as jprofile
from repro.core import sim_ctx as jsim_ctx
from repro.core import tuner as jtuner
from repro_torch.core import (Profiler, TunedSelector, TuningDB, Tuner,
                              abmodel, epiphany3, sim_ctx)
from repro_torch.core import collectives as coll
from repro_torch.core import fusion
from repro_torch.core import profile as profile_mod
from repro_torch.core import tuner as tuner_mod

TIMES = ("wall_s", "t_start", "issue_s", "stall_s")


def _np(n, nbytes, seed=0):
    w = max(1, int(nbytes) // 4)
    return np.random.RandomState(seed).randn(n, w).astype(np.float32)


def _pair(a):
    return torch.from_numpy(np.array(a)), jnp.asarray(a)


def samples_of(prof):
    return [{k: v for k, v in s.to_dict().items() if k not in TIMES}
            for s in prof.samples]


def counters_of(prof):
    return {k: {kk: vv for kk, vv in v.items()
                if kk not in ("total_s", "issue_s", "stall_s")}
            for k, v in prof.counters().items()}


def doc_of(prof):
    d = prof.to_json()
    d["counters"] = counters_of(prof)
    d["timeline"] = [{k: v for k, v in row.items() if k not in TIMES}
                     for row in d["timeline"]]
    return d


def assert_same_profile(prof, jprof):
    assert samples_of(prof) == samples_of(jprof)
    assert counters_of(prof) == counters_of(jprof)


def ctx_pair(n, mesh, **kw):
    if mesh:
        return (sim_ctx(n, epiphany3(), device="cpu", **kw.get("port", {})),
                jsim_ctx(n, jepiphany3(), **kw.get("ref", {})))
    return (sim_ctx(n, device="cpu", **kw.get("port", {})),
            jsim_ctx(n, **kw.get("ref", {})))


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------

def test_pcontrol_levels():
    profs = Profiler(level=2), JProfiler(level=2)
    for p in profs:
        with p.op("allreduce", nbytes=64, n_pes=4):
            pass
        assert len(p.samples) == 1
        p.pcontrol(1)
        with p.op("allreduce", nbytes=64, n_pes=4):
            pass
        assert len(p.samples) == 1
        assert p.counters()["collective.allreduce"]["count"] == 2
        p.pcontrol(0)
        with p.op("allreduce", nbytes=64, n_pes=4) as s:
            assert s is None
        assert p.counters()["collective.allreduce"]["count"] == 2
        assert not p.enabled
    assert_same_profile(*profs)


def test_op_sample_fields_and_note():
    got = []
    for P, C, A in ((Profiler, coll, abmodel), (JProfiler, jcoll, jab)):
        p = P(level=2)
        sched = C.allreduce_schedule(8, 1024.0, "ring")
        with p.op("allreduce", nbytes=1024, n_pes=8, fingerprint="flat:n8"):
            p.note(algorithm="ring", chunks=2, schedule=sched,
                   link=A.EPIPHANY_NOC)
        (s,) = p.samples
        assert s.wall_s > 0 and not s.traced
        assert s.predicted_s == pytest.approx(
            sched.pipelined_time(2, None, A.EPIPHANY_NOC))
        got.append(p)
    assert_same_profile(*got)
    assert got[0].samples[0].stage_costs == got[1].samples[0].stage_costs


def test_bare_note_and_foreign_note_record_selection_samples():
    profs = Profiler(level=2), JProfiler(level=2)
    for p in profs:
        p.note(algorithm="rd", collective="allreduce", nbytes=64, n_pes=4)
        with p.op("train_step", n_pes=4):
            # a selection made inside another timed region must not
            # relabel it: it commits as its own "selection" sample
            p.note(algorithm="ring", collective="allreduce", nbytes=32,
                   n_pes=4)
        assert [s.kind for s in p.samples] == ["selection", "selection",
                                               "collective"]
        assert p.samples[2].algorithm == ""
    assert_same_profile(*profs)


def test_json_export_roundtrip_and_cross_load(tmp_path):
    profs = Profiler(level=2), JProfiler(level=2)
    for p in profs:
        with p.op("fcollect", nbytes=256, n_pes=4):
            p.note(algorithm="ring", chunks=1)
        with p.op("train_step", n_pes=4):     # predicted_s stays NaN
            pass
    path = tmp_path / "profile.json"
    profs[0].dump(path)
    text = path.read_text()
    assert "NaN" not in text
    doc = json.loads(text)
    assert doc["schema"] == 1
    assert doc["counters"]["collective.fcollect.ring"]["count"] == 1
    assert doc["timeline"][1]["predicted_s"] is None
    assert doc_of(profs[0]) == doc_of(profs[1])
    assert sorted(doc) == sorted(profs[1].to_json())


@pytest.mark.parametrize("n,mesh,noc", [(4, False, False), (16, True, False),
                                        (16, True, True)],
                         ids=["n4", "mesh4x4", "mesh4x4-noc"])
def test_sim_ctx_records_collective_samples(n, mesh, noc):
    prof, jprof = Profiler(level=2), JProfiler(level=2)
    topo, jtopo = (epiphany3(), jepiphany3()) if mesh else (None, None)
    ctx = sim_ctx(n, topo, noc=noc, device="cpu", profile=prof)
    jctx = jsim_ctx(n, jtopo, noc=noc, profile=jprof)
    x, jx = _pair(_np(n, 4096))
    a, ja = _pair(_np(n, n * 64, seed=1))
    for c, v, w in ((ctx, x, a), (jctx, jx, ja)):
        c.to_all(v, "sum", algorithm="auto")
        c.to_all(v, "sum", algorithm="ring", pipeline_chunks=2)
        c.fcollect(v)
        c.collect(v)
        c.broadcast(v, root=3)
        c.alltoall(w)
        c.reduce_scatter(v)
        c.barrier()
    for s in prof.samples:
        assert s.kind == "collective" and s.algorithm and s.wall_s > 0
        assert not s.traced
        if mesh:
            assert s.fingerprint.startswith("mesh4x4")
    assert any(k.startswith("ppermute[") for k in prof.counters())
    assert_same_profile(prof, jprof)


def test_team_and_partition_collectives_note_like_the_reference():
    prof, jprof = Profiler(level=2), JProfiler(level=2)
    ctx = sim_ctx(16, epiphany3(), device="cpu", profile=prof)
    jctx = jsim_ctx(16, jepiphany3(), profile=jprof)
    x, jx = _pair(_np(16, 1024))
    for c, v in ((ctx, x), (jctx, jx)):
        team = c.team_split_strided(None, 0, 2, 8)
        c.to_all(v, "sum", team=team)
        c.to_all(v, "sum", algorithm="hier", partition=c.team_split_2d())
        c.to_all(v, "sum", PE_start=0, logPE_stride=1, PE_size=8)
    assert_same_profile(prof, jprof)
    assert {s.team for s in prof.samples} == {"team8of16", "part4x4"}


def test_rma_and_quiet_counters():
    prof, jprof = Profiler(level=2), JProfiler(level=2)
    ctx, jctx = sim_ctx(4, device="cpu", profile=prof), \
        jsim_ctx(4, profile=jprof)
    x, jx = _pair(_np(4, 64))
    for c, v in ((ctx, x), (jctx, jx)):
        c.put_nbi(v, [(0, 1)])
        c.get_nbi(v, [(2, 3)])
        c.quiet()
    c = prof.counters()
    assert c["rma.put"]["count"] == 1 and c["rma.get"]["count"] == 1
    assert c["quiet.drained"]["count"] == 2
    assert sum(1 for s in prof.samples if s.kind == "rma") == 2
    assert_same_profile(prof, jprof)


def test_pcontrol_attaches_profiler_lazily():
    ctx = sim_ctx(4, device="cpu")
    assert ctx.profile is None
    ctx.pcontrol(0)
    assert ctx.profile is None
    ctx.pcontrol(2)
    assert ctx.profile is not None and ctx.net.profile is ctx.profile
    x = torch.from_numpy(_np(4, 64))
    ctx.to_all(x, "sum")
    assert len(ctx.profile.samples) == 1
    ctx.pcontrol(0)
    ctx.to_all(x, "sum")
    assert len(ctx.profile.samples) == 1


def test_disabled_profiler_pays_nothing(monkeypatch):
    """pcontrol(0): no sample, no counter and no device wait."""
    waits = []
    monkeypatch.setattr(profile_mod, "wait_device", waits.append)
    prof = Profiler(level=0)
    ctx = sim_ctx(4, device="cpu", profile=prof)
    ctx.to_all(torch.from_numpy(_np(4, 64)), "sum")
    assert prof.samples == [] and prof.counters() == {} and waits == []


def test_enabled_op_waits_on_its_device_and_not_under_capture(monkeypatch):
    waits = []
    monkeypatch.setattr(profile_mod, "wait_device", waits.append)
    prof = Profiler(level=2)
    ctx = sim_ctx(4, device="cpu", profile=prof)
    ctx.to_all(torch.from_numpy(_np(4, 64)), "sum")
    assert waits == [torch.device("cpu")] * 2       # as it opens and closes
    monkeypatch.setattr(profile_mod, "trace_clean", lambda: False)
    ctx.to_all(torch.from_numpy(_np(4, 64)), "sum")
    assert waits == [torch.device("cpu")] * 2 + [None] * 2
    assert prof.samples[-1].traced


def test_sample_on_a_cuda_net_that_cannot_wait_raises():
    prof = Profiler(level=2)
    with pytest.raises((RuntimeError, AssertionError, AttributeError)):
        with prof.op("allreduce", n_pes=4,
                     device=torch.device("cuda", 99)):
            pass
    assert prof.samples == []


def test_measure_records_sample_and_runs_warmup_plus_iters():
    calls = []

    def fn(v):
        calls.append(1)
        return v + 1

    got = []
    for P, mod, v in ((Profiler, profile_mod, torch.zeros(8)),
                      (JProfiler, jprofile, None)):
        p = P(level=2)
        if v is None:
            t = mod.measure(lambda u: u + 1, jnp.zeros((8,)), iters=2,
                            profile=p, collective="allreduce", nbytes=32.0,
                            n_pes=8, algorithm="ring", chunks=1,
                            fingerprint="flat:n8")
        else:
            t = mod.measure(fn, v, iters=2, warmup=3, profile=p,
                            collective="allreduce", nbytes=32.0, n_pes=8,
                            algorithm="ring", chunks=1,
                            fingerprint="flat:n8")
        assert t > 0
        (s,) = p.samples
        assert s.kind == "measure" and s.wall_s == pytest.approx(t)
        got.append(p)
    assert len(calls) == 3 + 2
    assert_same_profile(*got)


# ---------------------------------------------------------------------------
# tuning DB
# ---------------------------------------------------------------------------

RECORDS = [
    (("flat:n8", "allreduce", "n8", 4096, "ring", 1, None, 2e-4), {}),
    (("flat:n8", "allreduce", "n8", 4096, "rd", 1, None, 1e-4), {}),
    (("flat:n8", "allreduce", "n8", 4096, "rd", 4, None, 3e-4),
     dict(predicted_s=2.5e-4)),
    (("flat:n8", "allreduce", "n8", 4000, "rd", 1, None, 1.5e-4), {}),
    (("flat:n8", "allreduce", "n8", 256, "ring", 1, None, 2e-3),
     dict(source="live")),
    (("flat:n8", "allreduce", "n8", 4096, "ring", 1, None, 1e-6),
     dict(source="live", predicted_s=float("nan"))),
    (("flat:n8", "fcollect", "n8", 1 << 14, "ring_emb", 2,
      (0, 1, 3, 2, 4, 5, 7, 6), 5e-5), {}),
    (("flat:n8", "allreduce", "n8", 64, "", 1, None, 1e-4), {}),   # no algo
]


def _filled(DB):
    db = DB()
    for args, kw in RECORDS:
        db.record(*args, **kw)
    for t in (1e-4, 2e-4, 3e-4):
        db.record("f", "allreduce", "n4", 256, "ring", 1, None, t)
    return db


def test_db_record_best_and_roundtrip(tmp_path):
    db, jdb = _filled(TuningDB), _filled(JTuningDB)
    assert db.to_json() == jdb.to_json()
    v = db.entries[db.key("f", "allreduce", "n4", 256)]["variants"]
    assert v["ring|c1|"]["n"] == 3
    assert v["ring|c1|"]["mean_s"] == pytest.approx(2e-4)
    queries = [dict(), dict(algos=["ring"]), dict(max_chunks=1),
               dict(algos=["ring_emb"]), dict(widen=2)]
    for coll_, nb in (("allreduce", 4096), ("allreduce", 4000),
                      ("allreduce", 256), ("allreduce", 1 << 20),
                      ("allreduce", 1 << 14), ("fcollect", 1 << 14),
                      ("fcollect", 1 << 15)):
        for q in queries:
            assert db.best("flat:n8", coll_, "n8", nb, **q) == \
                jdb.best("flat:n8", coll_, "n8", nb, **q)
        assert db.variants("flat:n8", coll_, "n8", nb) == \
            jdb.variants("flat:n8", coll_, "n8", nb)
    assert db.best("flat:n8", "allreduce", "n8", 4096)[:3] == ("rd", 1, "")
    assert db.best("flat:n8", "allreduce", "n8", 1 << 20) is None
    db.set_link("flat:n8", abmodel.LinkModel(1e-6, 0.0, 1e9, 0.5))
    jdb.set_link("flat:n8", jab.LinkModel(1e-6, 0.0, 1e9, 0.5))
    # each package loads the other's file
    p, jp = tmp_path / "port.json", tmp_path / "ref.json"
    db.save(p)
    jdb.save(jp)
    assert "NaN" not in p.read_text()
    assert p.read_text() == jp.read_text()
    for a, b in ((JTuningDB.load(p), jdb), (TuningDB.load(jp), db)):
        assert a.to_json() == b.to_json()
        lk = a.link_model("flat:n8")
        assert lk.bw_Bps == 1e9 and lk.contention == 0.5
        assert a.link_model("missing") is None
        assert len(a) == len(b)


def test_nbytes_bucket_fingerprint_and_variant_keys():
    for nb in (0, 1, 2, 3, 6000, 8000, 4096, 1 << 20, 12345.6):
        assert tuner_mod.nbytes_bucket(nb) == jtuner.nbytes_bucket(nb)
    for topo, jtopo, n, dead in ((None, None, 8, ()),
                                 (epiphany3(), jepiphany3(), 16, ()),
                                 (epiphany3(), jepiphany3(), 16, (5, 2)),
                                 (epiphany3(), jepiphany3(), 8, ())):
        assert tuner_mod.fingerprint(topo, n, dead) == \
            jtuner.fingerprint(jtopo, n, dead)
    for v in (("ring", 4, None), ("ring_emb", 1, "snake"),
              ("ring_emb", 2, (0, 2, 1, 3))):
        k = tuner_mod.variant_key(*v)
        assert k == jtuner.variant_key(*v)
        assert tuner_mod.split_variant(k) == jtuner.split_variant(k)


def test_selector_answers_match_the_reference():
    topo, jtopo = epiphany3(), jepiphany3()
    n = topo.n_pes
    fp = tuner_mod.fingerprint(topo, n)
    ref = coll.EMBED_REF_BYTES
    dbs = TuningDB(), JTuningDB()
    sels = TunedSelector(dbs[0]), JTunedSelector(dbs[1])

    def answers(sel, t):
        return (sel.algorithm("allreduce", n, ref, t),
                sel.algorithm("allreduce", n, ref, t, candidates=["rd"]),
                sel.schedule("allreduce", n, ref, t),
                sel.schedule("allreduce", n, ref, t, max_chunks=1),
                sel.chunks("allreduce", "rd", n, ref, t),
                sel.chunks("allreduce", "ring", n, ref, t),
                sel.embedding(n, ref, t),
                sel.with_fingerprint("other").algorithm(
                    "allreduce", n, ref, t))

    steps = [("ring", 1, None, 1e-4), ("rd", 4, None, 2e-4),
             ("ring_emb", 1, "snake", 5e-5),
             ("ring_emb", 2, topo.snake_order(), 1e-5)]
    assert answers(sels[0], topo) == answers(sels[1], jtopo)
    for a, c, e, t in steps:
        for db in dbs:
            db.record(fp, "allreduce", f"n{n}", ref, a, c, e, t)
        assert answers(sels[0], topo) == answers(sels[1], jtopo)
    assert tuple(sels[0].embedding(n, ref, topo)) == topo.snake_order()


# ---------------------------------------------------------------------------
# selector precedence in choose_*
# ---------------------------------------------------------------------------

def test_choose_star_consult_the_tuner_first_like_the_reference():
    topo, jtopo = epiphany3(), jepiphany3()
    dbs = TuningDB(), JTuningDB()
    for db in dbs:
        db.record("flat:n8", "allreduce", "n8", 256, "ring", 1, None, 1e-6)
        db.record("flat:n8", "allreduce", "n8", 65536, "ring", 8, None,
                  1e-6)
        db.record("flat:n8", "allreduce", "n8", 65536, "rd", 16, None,
                  2e-6)
        db.record(tuner_mod.fingerprint(topo, 16), "allreduce", "n16",
                  coll.EMBED_REF_BYTES, "ring", 1, None, 1e-6)
        db.record("flat:n8", "attention", "n8", 8 << 20, "mono", 1, None,
                  1e-3)
        db.record("flat:n8", "grad_sync", "n8", 1 << 22, "bucketed", 1,
                  None, 1e-3)
    sel, jsel = TunedSelector(dbs[0]), JTunedSelector(dbs[1])
    L, JL = abmodel.EPIPHANY_NOC, jab.EPIPHANY_NOC
    for nb in (256, 65536, 1 << 22):
        assert coll.choose_algorithm(8, nb, None, L, tuner=sel) == \
            jcoll.choose_algorithm(8, nb, None, JL, tuner=jsel)
        for mc in (16, 4):
            assert coll.choose_schedule(8, nb, None, L, max_chunks=mc,
                                        tuner=sel) == \
                jcoll.choose_schedule(8, nb, None, JL, max_chunks=mc,
                                      tuner=jsel)
    assert coll.choose_algorithm(8, 256, None, L, tuner=sel) == "ring"
    assert coll.choose_schedule(8, 65536, None, L, tuner=sel) == ("ring", 8)
    stages = coll.allreduce_schedule(8, 65536, "ring").cost(None)
    for key in (("allreduce", "ring", 8, 65536, None),
                ("allreduce", "rd", 8, 65536, None),
                ("allreduce", "ring", 8, 128, None), None):
        got = abmodel.choose_chunks(stages, L, tuner=sel, key=key)
        assert got == jab.choose_chunks(stages, JL, tuner=jsel, key=key)
    assert abmodel.choose_chunks(stages, L, tuner=sel, key=(
        "allreduce", "ring", 8, 65536, None)) == 8
    assert coll.choose_embedding(16, topo, L, tuner=sel) is None
    assert jcoll.choose_embedding(16, jtopo, JL, tuner=jsel) is None
    assert coll.choose_embedding(16, topo, L) is not None
    # the fused variants: a measured verdict wins over the model
    for args in ((8, 1 << 20, 1.0), (8, 1 << 20, 1e-9), (4, 1 << 20, 1.0)):
        assert fusion.choose_attention(*args, tuner=sel) == \
            jfusion.choose_attention(*args, tuner=jsel)
    assert fusion.choose_attention(8, 1 << 20, 1.0)[0] == "ring"
    assert fusion.choose_attention(8, 1 << 20, 1.0, tuner=sel)[0] == "mono"
    for args in ((8, 1 << 22, 2), (8, 1 << 22, 4), (8, 4096, 2)):
        assert fusion.choose_grad_rs(*args, tuner=sel) == \
            jfusion.choose_grad_rs(*args, tuner=jsel)
    assert fusion.choose_grad_rs(8, 1 << 22, 2, tuner=sel)[0] == "bucketed"


def test_tuned_pick_runs_and_matches_untuned_result():
    """A DB-forced algorithm changes the schedule, not the numbers."""
    n = 16
    topo = epiphany3()
    x = torch.from_numpy(_np(n, 4096))
    db = TuningDB()
    db.record(tuner_mod.fingerprint(topo, n), "allreduce", f"n{n}", 4096,
              "ring", 2, None, 1e-6)
    prof = Profiler(level=2)
    tuned = sim_ctx(n, topo, device="cpu", tuner=TunedSelector(db),
                    profile=prof)
    plain = sim_ctx(n, topo, device="cpu")
    a = tuned.to_all(x, "sum", algorithm="auto", pipeline_chunks="auto")
    b = plain.to_all(x, "sum", algorithm="auto")
    assert (prof.samples[0].algorithm, prof.samples[0].chunks) == ("ring", 2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# calibration sweep — the acceptance properties, on the real timer
# ---------------------------------------------------------------------------

GRID = {"collectives": ("allreduce", "fcollect"), "sizes": (256, 4096),
        "chunks": (1, 2), "iters": 2, "warmup": 1}


@pytest.fixture(scope="module")
def swept():
    ctx = sim_ctx(4, device="cpu", profile=Profiler(level=2))
    tuner = Tuner(link=abmodel.EPIPHANY_NOC)
    summary = tuner.tune(ctx, GRID)
    return ctx, tuner, summary


def test_sweep_fills_db_and_reports(swept):
    ctx, tuner, summary = swept
    assert summary["points"] == 4 and len(tuner.db) == 4
    assert summary["fingerprint"] == "flat:n4"
    n_var = sum(len(tuner._variants(c, 4, nb, None, tuner.link,
                                    GRID["chunks"]))
                for c in GRID["collectives"] for nb in GRID["sizes"])
    assert summary["variants"] == n_var
    kinds = {s.kind for s in ctx.profile.samples}
    assert "measure" in kinds


def test_sweep_selector_picks_measured_best(swept):
    ctx, tuner, _ = swept
    sel = tuner.selector()
    for collective in GRID["collectives"]:
        for nbytes in GRID["sizes"]:
            variants = tuner.db.variants("flat:n4", collective, "n4", nbytes)
            meas = {tuner_mod.split_variant(k)[:2]: v["mean_s"]
                    for k, v in variants.items()}
            best = min(meas, key=meas.get)
            pick = sel.schedule(collective, 4, nbytes, None)
            assert pick == best, (collective, nbytes)
            a = coll.choose_schedule(4, nbytes, None, tuner.link,
                                     collective=collective)
            assert a in meas and meas[pick] <= meas[a]


def test_sweep_refits_link_model_and_roundtrips(swept, tmp_path):
    _, tuner, _ = swept
    lk = tuner.db.link_model("flat:n4")
    assert lk is not None and lk.alpha_s > 0 and lk.bw_Bps > 0
    assert tuner.link_model(None, 4).alpha_s == lk.alpha_s
    assert tuner.link_model(epiphany3(), 16) is tuner.link
    path = tmp_path / "tuning_db.json"
    tuner.save(path)
    for reloaded in (Tuner(path=str(path)), JTuner(path=str(path))):
        sel_a, sel_b = tuner.selector(), reloaded.selector()
        for collective in GRID["collectives"]:
            for nbytes in GRID["sizes"]:
                assert sel_a.schedule(collective, 4, nbytes, None) == \
                    sel_b.schedule(collective, 4, nbytes, None)
        assert reloaded.db.link_model("flat:n4").bw_Bps == lk.bw_Bps


def test_tune_rejects_a_non_sim_context():
    class FakeCtx:
        class net:
            pass
    for T in (Tuner, JTuner):
        with pytest.raises(ValueError, match="SIM"):
            T().tune(FakeCtx())


def test_variants_match_the_reference():
    for topo, jtopo, n in ((None, None, 4), (None, None, 6),
                           (epiphany3(), jepiphany3(), 16)):
        for c in ("allreduce", "fcollect"):
            for nb in (256, 65536, 1 << 20):
                got = Tuner()._variants(c, n, nb, topo, abmodel.ICI_V5E,
                                        (1, 4))
                want = JTuner()._variants(c, n, nb, jtopo, jab.ICI_V5E,
                                          (1, 4))
                assert got == want


def _fake_measure(calls):
    """One deterministic timer for both packages: runs the op once, then
    answers from the call's order and payload — no wall clock."""
    def measure(fn, *args, warmup=2, iters=5, profile=None, **kw):
        fn(*args)
        k = len(calls)
        x = args[0]
        nbytes = (x.numel() if isinstance(x, torch.Tensor) else x.size) * 4
        t = 1e-5 + 1e-9 * nbytes * (1.0 + 0.25 * (k % 3)) + 1e-7 * k
        calls.append((kw.get("collective"), kw.get("algorithm"),
                      kw.get("chunks"), kw.get("embedding") is not None,
                      nbytes, warmup, iters))
        return t
    return measure


@pytest.mark.parametrize("mesh", [False, True], ids=["n4", "mesh4x4"])
def test_tune_and_refit_summaries_match_the_reference(monkeypatch, mesh):
    calls, jcalls = [], []
    monkeypatch.setattr(tuner_mod, "measure", _fake_measure(calls))
    monkeypatch.setattr(jtuner, "measure", _fake_measure(jcalls))
    ctx, jctx = ctx_pair(16 if mesh else 4, mesh)
    grid = dict(GRID, sizes=(256, 65536), chunks=(1, 4))
    got = Tuner().tune(ctx, grid)
    want = JTuner().tune(jctx, grid)
    assert calls == jcalls and got == want
    t, jt = Tuner(), JTuner()
    lk = t.refit_link(ctx, sizes=(256, 4096))
    jlk = jt.refit_link(jctx, sizes=(256, 4096))
    assert (lk.alpha_s, lk.hop_s, lk.bw_Bps, lk.contention) == \
        (jlk.alpha_s, jlk.hop_s, jlk.bw_Bps, jlk.contention)
    assert t.db.to_json() == jt.db.to_json()


# ---------------------------------------------------------------------------
# online refinement: profiler sink -> DB
# ---------------------------------------------------------------------------

def test_online_refinement_from_profiler_samples():
    prof = Profiler(level=2)
    tuner = Tuner()
    ctx = sim_ctx(8, device="cpu", profile=prof, tuner=tuner)
    x = torch.from_numpy(_np(8, 4096))
    ctx.to_all(x, "sum", algorithm="ring")
    ctx.to_all(x, "sum", algorithm="rd")
    variants = tuner.db.variants("flat:n8", "allreduce", "n8", 4096)
    algos = {tuner_mod.split_variant(k)[0] for k in variants}
    assert algos == {"ring", "rd"}
    assert all(v["live_n"] == 1 and v["n"] == 0 for v in variants.values())
    assert tuner.selector().algorithm("allreduce", 8, 4096, None) in algos


def test_observe_skips_traced_measure_and_unkeyed_samples():
    for T, mod in ((Tuner, profile_mod), (JTuner, jprofile)):
        tuner = T()
        base = dict(collective="allreduce", nbytes=4096, n_pes=8,
                    team="n8", algorithm="ring", wall_s=1e-4,
                    fingerprint="flat:n8")
        for bad in (dict(traced=True), dict(kind="measure"),
                    dict(fingerprint=""), dict(algorithm=""),
                    dict(wall_s=0.0), dict(n_pes=0)):
            tuner.observe(mod.OpSample(**{**base, **bad}))
        assert len(tuner.db) == 0
        tuner.observe(mod.OpSample(**base))
        assert len(tuner.db) == 1


def test_tune_with_attached_sink_counts_each_variant_once():
    prof = Profiler(level=2)
    tuner = Tuner()
    ctx = sim_ctx(4, device="cpu", profile=prof, tuner=tuner)
    tuner.tune(ctx, {"collectives": ("allreduce",), "sizes": (256,),
                     "chunks": (1,), "iters": 2, "warmup": 1})
    variants = tuner.db.variants("flat:n4", "allreduce", "n4", 256)
    assert variants and all(v["n"] == 1 and v.get("live_n", 0) == 0
                            for v in variants.values())


def test_refingerprint_rekeys_samples_and_lookups():
    db = TuningDB()
    db.record("flat:n8", "allreduce", "n8", 256, "ring", 1, None, 1e-6)
    prof = Profiler(level=2)
    ctx = sim_ctx(8, device="cpu", profile=prof, tuner=TunedSelector(db))
    x = torch.from_numpy(_np(8, 256))
    ctx.to_all(x, "sum", algorithm="auto")
    assert prof.samples[-1].algorithm == "ring"
    ctx.refingerprint("flat:n8:dead3")
    ctx.to_all(x, "sum", algorithm="auto")
    assert prof.samples[-1].fingerprint == "flat:n8:dead3"
    assert prof.samples[-1].algorithm == coll.choose_algorithm(8, 256.0)
    ctx2 = sim_ctx(8, device="cpu", profile=Profiler(level=2),
                   fingerprint="fp:x")
    ctx2.to_all(x, "sum")
    assert ctx2.profile.samples[0].fingerprint == "fp:x"
