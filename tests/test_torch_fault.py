"""The port's fault layer on the CPU against the JAX package: the
declarative FaultPlan, the injector against live SIM and NoC-SIM traffic
(dead PE, dropped link with YX reroute, transient drops healing under
retry/backoff, stragglers at quiet/fence deadlines), fault events into a
Tracer and `tracereport`, the checkpoint layer (crash atomicity, typed
errors, the elastic reshard), the PGAS checkpoint stream, elastic
degrade/recover, the toy kill-and-resume, and the serving engine's drain.

Case for case the reference's `tests/test_fault.py`, each run through
both packages on the same numpy inputs (4x4 `epiphany3`, KB payloads):
plans, errors, stats, rings and fingerprints exactly; data movement and
checkpoints bit for bit; f32 losses at rtol 1e-4/atol 1e-5.  The
reference's tp=2 SPMD kill-and-resume waits for the port's SPMD
backend."""
import json
import shutil
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import manager as jckpt
from repro.ckpt.pgas import PgasCheckpointer as JPgasCheckpointer
from repro.configs import smoke_config as jax_smoke
from repro.core import RetryPolicy as JRetryPolicy
from repro.core import elastic as jelastic
from repro.core import fault as jfault
from repro.core import sim_ctx as jsim_ctx
from repro.core.profile import Profiler as JProfiler
from repro.core.topology import epiphany3 as jepiphany3
from repro.core.trace import LEVEL_FULL as JLEVEL_FULL
from repro.core.trace import Tracer as JTracer
from repro.launch.mesh import make_mesh
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.metrics import ServeMetrics as JServeMetrics
from repro.tools import tracereport as jtracereport
from repro_torch.ckpt import manager as ckpt
from repro_torch.ckpt.pgas import PgasCheckpointer
from repro_torch.configs import smoke_config
from repro_torch.core import RetryPolicy, elastic, sim_ctx
from repro_torch.core.fault import (DeadlineExceeded, FaultInjector,
                                    FaultPlan, LinkFailure, PEFailure,
                                    as_injector)
from repro_torch.core.profile import Profiler
from repro_torch.core.topology import epiphany3
from repro_torch.core.trace import LEVEL_FULL, Tracer
from repro_torch.kernels import put_copy as pc
from repro_torch.kernels import reduce_combine as rc
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.tools import tracereport

TOPO, JTOPO = epiphany3(), jepiphany3()      # 4x4, 16 PEs
N = TOPO.n_pes
FAST = dict(max_retries=3, backoff_s=1e-5, backoff_mult=2.0)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


def payload(n=N, w=4, seed=0):
    return np.random.RandomState(seed).randn(n, w).astype(np.float32)


def pair_ctx(noc=False, plan_fn=None, retry=FAST, **kw):
    """The same context in both packages: (port, reference); `plan_fn`
    builds the same FaultPlan in each from its package's class."""
    pkw, jkw = dict(kw), dict(kw)
    if plan_fn is not None:
        pkw["fault"] = plan_fn(FaultPlan())
        jkw["fault"] = plan_fn(jfault.FaultPlan())
    return (sim_ctx(N, TOPO, noc=noc, device="cpu",
                    retry=RetryPolicy(**retry), **pkw),
            jsim_ctx(N, JTOPO, noc=noc, retry=JRetryPolicy(**retry),
                     **jkw))


def same(got, want):
    """Bit for bit: a port tensor against a reference array."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32) if got.dtype ==
                                  np.float32 else got,
                                  want.view(np.uint32) if want.dtype ==
                                  np.float32 else want)


def raises_both(exc_port, exc_ref, fn_port, fn_ref):
    """Both calls raise; returns (port error, reference error)."""
    with pytest.raises(exc_port) as a:
        fn_port()
    with pytest.raises(exc_ref) as b:
        fn_ref()
    return a.value, b.value


def same_error(e, je):
    assert type(e).__name__ == type(je).__name__
    assert (e.pe, e.link, e.step, e.op, e.attempts) == \
        (je.pe, je.link, je.step, je.op, je.attempts)
    if je.pattern is None:
        assert e.pattern is None
    else:
        assert e.pattern.pairs == je.pattern.pairs


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts calls of kernels 1-3's wrappers (on the CPU each runs its
    plain version): a faulted pattern must reach none of them."""
    calls = {"put_copy": 0, "reduce_combine": 0}
    for mod, name in ((pc, "put_copy"), (rc, "reduce_combine")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


# ---------------------------------------------------------------------------
# FaultPlan: pure data
# ---------------------------------------------------------------------------

def _chain(plan):
    return (plan.slow_pe(1, pe=7, delay_s=0.05)
                .drop_link(2, 4, 5, heal_after=2)
                .kill_pe(3, pe=9)
                .heal_straggler(4, pe=7)
                .heal_link(5, 4, 5)
                .heal_pe(6, pe=9))


def test_fault_plan_state_is_cumulative_and_heals():
    plan, jplan = _chain(FaultPlan()), _chain(jfault.FaultPlan())
    assert [tuple(vars(e).values()) for e in plan.events] == \
        [tuple(vars(e).values()) for e in jplan.events]
    for step in range(-1, 9):
        assert plan.state_at(step) == jplan.state_at(step), step
    assert plan.state_at(0) == (frozenset(), {}, {})
    assert plan.state_at(3) == (frozenset({9}), {(4, 5): 2}, {7: 0.05})
    assert plan.state_at(99) == (frozenset(), {}, {})
    assert repr(plan) == repr(jplan)
    bad, jbad = FaultPlan(), jfault.FaultPlan()
    bad.events.append(type(plan.events[0])(0, "meteor", (1,)))
    jbad.events.append(type(jplan.events[0])(0, "meteor", (1,)))
    e, je = raises_both(ValueError, ValueError, lambda: bad.state_at(0),
                        lambda: jbad.state_at(0))
    assert str(e) == str(je)


def test_fault_plan_link_key_is_canonical():
    for a, b in ((5, 4), (4, 5), (0, 0)):
        assert FaultPlan().drop_link(0, a, b).state_at(0) == \
            jfault.FaultPlan().drop_link(0, a, b).state_at(0)
    assert FaultPlan().drop_link(0, 5, 4).state_at(0)[1] == {(4, 5): None}


def test_as_injector_normalizes_the_knob():
    plan = FaultPlan()
    inj = FaultInjector(plan)
    assert as_injector(None) is None
    assert as_injector(inj, topo=TOPO) is inj and inj.topo is TOPO
    fresh = as_injector(plan, topo=TOPO)
    assert isinstance(fresh, FaultInjector) and fresh.plan is plan
    e, je = raises_both(TypeError, TypeError, lambda: as_injector(3),
                        lambda: jfault.as_injector(3))
    assert str(e) == str(je)


# ---------------------------------------------------------------------------
# injector against live traffic (SIM and NoC-SIM)
# ---------------------------------------------------------------------------

@pytest.fixture(params=[False, True], ids=["sim", "noc-sim"])
def noc(request):
    return request.param


def test_dead_pe_raises_typed_pe_failure(noc, kernel_calls):
    ctx, jctx = pair_ctx(noc, lambda p: p.kill_pe(3, pe=5))
    x = payload()
    same(ctx.quiet(ctx.put_nbi(torch.from_numpy(x), [(5, 6)]))[0],
         jctx.quiet(jctx.put_nbi(jnp.asarray(x), [(5, 6)]))[0])
    ctx.fault_injector.set_step(3)
    jctx.fault_injector.set_step(3)
    assert ctx.fault_injector.dead_pes == jctx.fault_injector.dead_pes \
        == (5,)
    before = dict(kernel_calls)
    e, je = raises_both(
        PEFailure, jfault.PEFailure,
        lambda: ctx.put_nbi(torch.from_numpy(x), [(5, 6)]),
        lambda: jctx.put_nbi(jnp.asarray(x), [(5, 6)]))
    same_error(e, je)
    assert e.pe == 5 and e.step == 3
    assert kernel_calls == before          # checked before any launch
    assert ctx.pending_count == 0
    e, je = raises_both(PEFailure, jfault.PEFailure,
                        lambda: ctx.to_all(torch.from_numpy(x), "sum"),
                        lambda: jctx.to_all(jnp.asarray(x), "sum"))
    same_error(e, je)
    assert kernel_calls == before
    same(ctx.quiet(ctx.put_nbi(torch.from_numpy(x), [(0, 1)]))[0],
         jctx.quiet(jctx.put_nbi(jnp.asarray(x), [(0, 1)]))[0])
    assert ctx.fault_injector.stats == jctx.fault_injector.stats \
        == {"fault.pe_hits": 2}


def test_dropped_link_takes_alternate_yx_route(noc):
    # XY route 0->6 is 0-1-2-6; dropping link (1,2) leaves the YX
    # alternate 0-4-5-6 intact -> traffic reroutes, no error
    ctx, jctx = pair_ctx(noc, lambda p: p.drop_link(0, 1, 2))
    clean = sim_ctx(N, TOPO, noc=noc, device="cpu")
    x = payload(w=16, seed=1)
    out = ctx.quiet(ctx.put_nbi(torch.from_numpy(x), [(0, 6)]))
    assert len(out) == 1
    assert torch.equal(out[0], clean.put(torch.from_numpy(x), [(0, 6)]))
    same(out[0], jctx.quiet(jctx.put_nbi(jnp.asarray(x), [(0, 6)]))[0])
    assert ctx.fault_injector.stats == jctx.fault_injector.stats \
        == {"fault.reroutes": 1}


def test_both_routes_severed_raises_link_failure(noc, kernel_calls):
    # sever the XY route (link 1-2) AND the YX alternate (link 4-5)
    retry = dict(max_retries=2, backoff_s=1e-5)
    ctx, jctx = pair_ctx(noc, lambda p: p.drop_link(0, 1, 2)
                         .drop_link(0, 4, 5), retry=retry)
    x = payload()
    e, je = raises_both(
        LinkFailure, jfault.LinkFailure,
        lambda: ctx.put_nbi(torch.from_numpy(x), [(0, 6)]),
        lambda: jctx.put_nbi(jnp.asarray(x), [(0, 6)]))
    same_error(e, je)
    assert e.link in {(1, 2), (4, 5)} and e.op == "put"
    assert e.attempts == 3                 # 1 issue + 2 retries
    assert kernel_calls == {"put_copy": 0, "reduce_combine": 0}
    assert ctx.fault_injector.stats == jctx.fault_injector.stats \
        == {"fault.link_hits": 3}


@pytest.mark.parametrize("heal_after", [1, 2])
def test_transient_link_heals_under_retry_backoff(noc, heal_after):
    # adjacent pair (0, 1): XY and YX routes are the same single link, so
    # the drop is unroutable — but heal_after=k makes it transient: the
    # k-th failed attempt heals it and attempt k + 1 succeeds
    prof, jprof = Profiler(level=1), JProfiler(level=1)
    plan = lambda p: p.drop_link(0, 0, 1, heal_after=heal_after)
    ctx = sim_ctx(N, TOPO, noc=noc, device="cpu", fault=plan(FaultPlan()),
                  retry=RetryPolicy(**FAST), profile=prof)
    jctx = jsim_ctx(N, JTOPO, noc=noc, fault=plan(jfault.FaultPlan()),
                    retry=JRetryPolicy(**FAST), profile=jprof)
    x = payload(seed=2)
    out = ctx.quiet(ctx.put_nbi(torch.from_numpy(x), [(0, 1)]))
    same(out[0], jctx.quiet(jctx.put_nbi(jnp.asarray(x), [(0, 1)]))[0])
    stats = ctx.fault_injector.stats
    assert stats == jctx.fault_injector.stats \
        == {"fault.link_hits": heal_after}
    assert prof.counters()["fault.retries"]["count"] == heal_after
    assert prof.counters()["fault.retries"] == \
        jprof.counters()["fault.retries"]
    # healed: later traffic over the link is clean
    ctx.quiet(ctx.put_nbi(torch.from_numpy(x), [(0, 1)]))
    assert stats["fault.link_hits"] == heal_after


def test_straggler_rides_future_and_deadline_fires(noc):
    ctx, jctx = pair_ctx(noc, lambda p: p.slow_pe(0, pe=3, delay_s=0.02))
    x = payload()
    f = ctx.put_nbi(torch.from_numpy(x), [(3, 2)])
    jf = jctx.put_nbi(jnp.asarray(x), [(3, 2)])
    assert f.delay_s == jf.delay_s == pytest.approx(0.02)
    # fence sees the doomed op without sleeping
    e, je = raises_both(DeadlineExceeded, jfault.DeadlineExceeded,
                        lambda: ctx.fence(deadline_s=0.01),
                        lambda: jctx.fence(deadline_s=0.01))
    same_error(e, je)
    # quiet under the deadline raises and leaves the queue UNTOUCHED
    e, je = raises_both(DeadlineExceeded, jfault.DeadlineExceeded,
                        lambda: ctx.quiet(deadline_s=0.01),
                        lambda: jctx.quiet(deadline_s=0.01))
    same_error(e, je)
    assert e.op == "put"
    assert ctx.pending_count == jctx.pending_count == 1
    # a generous deadline completes (and actually waits the delay)
    t0 = time.perf_counter()
    out = ctx.quiet(deadline_s=1.0)
    assert time.perf_counter() - t0 >= 0.02
    same(out[0], jctx.quiet(deadline_s=1.0)[0])
    assert ctx.pending_count == 0 and f.delay_s == 0.0
    assert ctx.fault_injector.stats == jctx.fault_injector.stats \
        == {"fault.straggler_hits": 1}


def test_retry_policy_default_deadline_applies():
    retry = dict(backoff_s=1e-5, deadline_s=0.01)
    ctx, jctx = pair_ctx(False, lambda p: p.slow_pe(0, pe=3, delay_s=0.05),
                         retry=retry)
    ctx.put_nbi(torch.from_numpy(payload()), [(3, 2)])
    jctx.put_nbi(jnp.asarray(payload()), [(3, 2)])
    e, je = raises_both(DeadlineExceeded, jfault.DeadlineExceeded,
                        ctx.quiet, jctx.quiet)   # no explicit deadline
    same_error(e, je)


def test_fault_events_land_on_tracer_and_tracereport(tmp_path):
    docs = []
    for pkg in ("port", "ref"):
        port = pkg == "port"
        tracer = Tracer(level=LEVEL_FULL) if port \
            else JTracer(level=JLEVEL_FULL)
        plan = (FaultPlan() if port else jfault.FaultPlan()) \
            .slow_pe(0, pe=3, delay_s=1e-4).drop_link(0, 1, 2)
        if port:
            ctx = sim_ctx(N, TOPO, device="cpu", fault=plan,
                          retry=RetryPolicy(**FAST), profile=tracer)
            arr = torch.from_numpy(payload())
        else:
            ctx = jsim_ctx(N, JTOPO, fault=plan,
                           retry=JRetryPolicy(**FAST), profile=tracer)
            arr = jnp.asarray(payload())
        ctx.quiet(ctx.put_nbi(arr, [(0, 6)]))       # reroute
        ctx.quiet(ctx.put_nbi(arr, [(3, 2)]))       # straggler
        path = tmp_path / f"{pkg}.json"
        tracer.dump_chrome(str(path))
        docs.append(json.loads(path.read_text()))
    doc, jdoc = docs
    assert tracereport.validate_trace(doc) == []
    counters = doc["repro"]["counters"]
    assert counters["fault.reroute"]["count"] == 1
    assert counters["fault.straggler"]["count"] == 1
    assert counters["fault.straggler_wait_us"]["count"] >= 1
    faults = lambda d: {k: v["count"] for k, v in
                        d["repro"]["counters"].items()
                        if k.startswith("fault.")}
    assert faults(doc) == faults(jdoc)
    inst = lambda d: [(e["name"], e.get("args")) for e in d["traceEvents"]
                      if e.get("ph") in ("i", "I")]
    assert inst(doc) == inst(jdoc)
    assert {"fault.reroute", "fault.straggler"} <= {n for n, _ in inst(doc)}
    lines = tracereport._chaos_report(doc["traceEvents"], doc["repro"])
    assert lines == jtracereport._chaos_report(jdoc["traceEvents"],
                                               jdoc["repro"])
    assert any("fault.reroute" in l for l in lines)
    assert any("instant events" in l for l in lines)


# ---------------------------------------------------------------------------
# checkpoint layer: atomicity, typed errors, async-save race, reshard
# ---------------------------------------------------------------------------

def _state(seed=0):
    r = np.random.RandomState(seed)
    return {"w": torch.from_numpy(r.randn(4, 3).astype(np.float32)),
            "opt": {"m": torch.from_numpy(r.randn(4, 3).astype(np.float32))}}


def test_async_save_snapshots_before_thread(tmp_path):
    state = _state()
    want = {"w": state["w"].clone(), "m": state["opt"]["m"].clone()}
    ft = ckpt.FaultToleranceManager(str(tmp_path), save_every=1,
                                    async_save=True)
    ft.on_step(1, lambda: state)
    state["w"].mul_(-1.0)                  # mutate mid-save, in place
    state["opt"]["m"][:] = 999.0
    ft._join()
    step, restored = ckpt.restore(tmp_path, _state())
    assert step == 1
    assert torch.equal(restored["w"], want["w"])
    assert torch.equal(restored["opt"]["m"], want["m"])


def test_restore_missing_leaf_raises_checkpoint_error(tmp_path):
    ckpt.save(tmp_path, 3, {"w": torch.zeros(4)})
    jckpt.save(tmp_path / "ref", 3, {"w": np.zeros(4, np.float32)})
    bad = {"w": torch.zeros(4), "extra": torch.zeros(2)}
    e, je = raises_both(
        ckpt.CheckpointError, jckpt.CheckpointError,
        lambda: ckpt.restore(tmp_path, bad),
        lambda: jckpt.restore(tmp_path / "ref",
                              {k: np.zeros(v.shape, np.float32)
                               for k, v in bad.items()}))
    assert "extra" in str(e) and "extra" in str(je)


def test_dangling_latest_falls_back_to_newest_complete(tmp_path):
    ckpt.save(tmp_path, 1, {"w": torch.full((4,), 1.0)})
    ckpt.save(tmp_path, 2, {"w": torch.full((4,), 2.0)})
    shutil.rmtree(tmp_path / "step-00000002")
    # LATEST still names step 2 — resolution must fall back
    assert ckpt.latest_step(tmp_path) == 1
    step, restored = ckpt.restore(tmp_path, {"w": torch.zeros(4)})
    assert step == 1 and restored["w"][0] == 1.0


def test_no_complete_checkpoint_is_typed_not_keyerror(tmp_path):
    assert ckpt.latest_step(tmp_path) is None
    with pytest.raises(ckpt.CheckpointError):
        ckpt.restore(tmp_path, {"w": torch.zeros(2)})


def test_crash_mid_save_keeps_previous_and_next_save_recovers(tmp_path):
    ckpt.save(tmp_path, 1, _state())
    tmp = tmp_path / "tmp-2"               # a crash mid-save
    tmp.mkdir()
    np.save(tmp / "partial.npy", np.zeros(2))
    assert ckpt.latest_step(tmp_path) == 1
    broken = tmp_path / "step-00000005"    # manifest names a missing file
    broken.mkdir()
    (broken / "manifest.json").write_text(json.dumps(
        {"step": 5, "leaves": [{"name": "w", "file": "gone.npy",
                                "shape": [2], "dtype": "float32"}]}))
    assert ckpt.latest_step(tmp_path) == 1
    ckpt.save(tmp_path, 2, _state(1))
    assert ckpt.latest_step(tmp_path) == 2


@pytest.mark.parametrize("target", [(6, 6), (2, 4), (2, 6), (1, 13),
                                    (5, 2)])
def test_reshard_shrink_grow_round_trips(target):
    a = np.arange(12, dtype=np.float32).reshape(2, 6)
    want = jckpt._reshard(a, target, "w")
    same(ckpt._reshard(torch.from_numpy(a), target, "w").contiguous(), want)
    back = ckpt._reshard(torch.from_numpy(want), (2, 6), "w")
    same(back.contiguous(), jckpt._reshard(want, (2, 6), "w"))
    e, je = raises_both(
        ValueError, ValueError,
        lambda: ckpt._reshard(torch.from_numpy(a), (2, 6, 1), "w"),
        lambda: jckpt._reshard(a, (2, 6, 1), "w"))
    assert str(e) == str(je)


def test_restore_reshards_bf16_and_refuses_shardings(tmp_path):
    a = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    ckpt.save(tmp_path, 1, {"w": a.to(torch.bfloat16)})
    _, got = ckpt.restore(tmp_path, {"w": torch.zeros(6, 4,
                                                      dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    same(got["w"].float(), jckpt._reshard(a.numpy(), (6, 4), "w"))
    # shardings place the leaves on the rank mesh: only in a rank process
    # (tests/test_torch_fsdp.py holds each rank's block to the reference)
    with pytest.raises(RuntimeError, match="rank process"):
        ckpt.restore(tmp_path, {"w": a}, shardings={"w": None})


# ---------------------------------------------------------------------------
# PGAS checkpoint stream: overlap + isolation + round trip
# ---------------------------------------------------------------------------

def _pgas_np(seed=0):
    r = np.random.RandomState(seed)
    return {"w": r.randn(N, 8).astype(np.float32),
            "opt": {"m": r.randn(N, 3).astype(np.float32)},
            "scale": np.float32(2.5)}


def _pgas_state(seed=0):
    s = _pgas_np(seed)
    return {"w": torch.from_numpy(s["w"]),
            "opt": {"m": torch.from_numpy(s["opt"]["m"])},
            "scale": torch.tensor(s["scale"])}


def _jpgas_state(seed=0):
    s = _pgas_np(seed)
    return {"w": jnp.asarray(s["w"]), "opt": {"m": jnp.asarray(s["opt"]["m"])},
            "scale": jnp.float32(s["scale"])}


def _saved_leaves(d) -> dict:
    """{leaf name: (shape, the saved array)} of the latest checkpoint."""
    sd = d / (d / "LATEST").read_text().strip()
    man = json.loads((sd / "manifest.json").read_text())
    return {l["name"]: (tuple(l["shape"]), np.load(sd / l["file"]))
            for l in man["leaves"]}


@pytest.mark.parametrize("async_issue", [False, True],
                         ids=["sync-issue", "async-issue"])
def test_pgas_checkpoint_round_trips(tmp_path, async_issue):
    ctx = sim_ctx(N, TOPO, device="cpu")
    jctx = jsim_ctx(N, JTOPO)
    state = _pgas_state()
    ck = PgasCheckpointer(ctx, tmp_path / "port", async_issue=async_issue)
    jck = JPgasCheckpointer(jctx, tmp_path / "ref", async_issue=async_issue)
    assert ck.order == jck.order and ck.fwd.pairs == jck.fwd.pairs
    n_rot = ck.begin(4, state)
    assert n_rot == jck.begin(4, _jpgas_state()) == 2 * (N - 1)
    assert ck.in_flight
    path = ck.drain()
    jck.drain()
    assert path is not None and ck.pending == 0 and not ck.in_flight
    got, want = _saved_leaves(tmp_path / "port"), \
        _saved_leaves(tmp_path / "ref")
    assert got.keys() == want.keys() == {"w", "opt/m", "scale"}
    for name, (shape, arr) in want.items():
        assert got[name][0] == shape
        assert got[name][1].dtype == arr.dtype
        assert got[name][1].tobytes() == arr.tobytes(), name
    step, restored = ckpt.restore(tmp_path / "port", _pgas_state(9))
    assert step == 4
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("async_issue", [False, True],
                         ids=["sync-issue", "async-issue"])
def test_pgas_begin_pins_state_against_in_place_writes(tmp_path,
                                                       async_issue):
    """Torch tensors are mutable: a train step writing the state in place
    right after begin() must not reach the checkpoint."""
    ctx = sim_ctx(N, TOPO, device="cpu")
    state = _pgas_state(3)
    want = {"w": state["w"].clone(), "m": state["opt"]["m"].clone(),
            "scale": state["scale"].clone()}
    ck = PgasCheckpointer(ctx, tmp_path, async_issue=async_issue)
    ck.begin(6, state)
    state["w"].add_(1.0)
    state["opt"]["m"].zero_()
    state["scale"].fill_(-1.0)
    ck.drain()
    _, restored = ckpt.restore(tmp_path, _pgas_state(9))
    assert torch.equal(restored["w"], want["w"])
    assert torch.equal(restored["opt"]["m"], want["m"])
    assert torch.equal(restored["scale"], want["scale"])


def test_pgas_stream_is_isolated_from_default_context(tmp_path):
    """Per-context isolation (DESIGN.md §11): the train step's own
    quiet() must not complete — or stall behind — checkpoint traffic."""
    ctx = sim_ctx(N, TOPO, device="cpu")
    ck = PgasCheckpointer(ctx, tmp_path, async_issue=False)
    ck.begin(0, _pgas_state())
    assert ck.pending == 2 * (N - 1)
    ctx.quiet(ctx.put_nbi(torch.from_numpy(payload()), [(0, 1)]))
    assert ctx.pending_count == 0          # default ctx drained ...
    assert ck.pending == 2 * (N - 1)       # ... ckpt stream untouched
    ck.drain()
    assert ck.pending == 0


def test_pgas_begin_auto_drains_previous_epoch(tmp_path):
    ctx = sim_ctx(N, TOPO, device="cpu")
    ck = PgasCheckpointer(ctx, tmp_path)
    ck.begin(1, _pgas_state(1))
    ck.begin(2, _pgas_state(2))            # drains epoch 1 first
    assert ckpt.latest_step(tmp_path) == 1
    ck.drain()
    assert ckpt.latest_step(tmp_path) == 2
    assert ck.drain() is None              # nothing in flight


@pytest.mark.parametrize("async_issue", [False, True],
                         ids=["sync-issue", "async-issue"])
def test_pgas_stream_surfaces_pe_failure_at_drain(tmp_path, async_issue):
    ctx = sim_ctx(N, TOPO, device="cpu", fault=FaultPlan().kill_pe(2, pe=5),
                  retry=RetryPolicy(**FAST))
    ctx.fault_injector.set_step(2)
    ck = PgasCheckpointer(ctx, tmp_path, async_issue=async_issue)
    ck.begin(2, _pgas_state())
    with pytest.raises(PEFailure) as ei:
        ck.drain()
    assert ei.value.pe == 5
    assert not ck.in_flight                # stream cleaned up
    assert ckpt.latest_step(tmp_path) is None


def test_pgas_order_must_be_a_permutation(tmp_path):
    ctx = sim_ctx(N, TOPO, device="cpu")
    with pytest.raises(ValueError, match="permutation"):
        PgasCheckpointer(ctx, tmp_path, order=range(N - 1))
    flat = PgasCheckpointer(sim_ctx(N, device="cpu"), tmp_path)
    assert flat.order == tuple(range(N))


# ---------------------------------------------------------------------------
# elastic: degraded mesh + kill-and-resume on SIM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dead", [[5], [0], [5, 9], [0, 3, 12, 15],
                                  [1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 13, 14],
                                  [21]])
def test_degrade_builds_live_ring_team_and_fingerprint(dead):
    dm, jdm = elastic.degrade(TOPO, dead), jelastic.degrade(JTOPO, dead)
    assert (dm.dead, dm.live, dm.fingerprint, dm.n_live) == \
        (jdm.dead, jdm.live, jdm.fingerprint, jdm.n_live)
    assert dm.team.members == jdm.team.members
    assert dm.team.world_n == jdm.team.world_n == N
    assert elastic._ring_cost(TOPO, dm.live) == \
        jelastic._ring_cost(JTOPO, jdm.live)
    assert not set(dm.dead) & set(dm.live)
    if dead == [5]:
        assert dm.fingerprint.endswith(":dead5")
        assert elastic._ring_cost(TOPO, dm.live)[0] == 1.0


@pytest.mark.parametrize("world_n,dead", [(4, [1]), (8, [0, 7]),
                                          (5, [2, 9])])
def test_degrade_flat_pe_space_needs_world_n(world_n, dead):
    for topo, jtopo in ((None, None), (TOPO, JTOPO)):
        dm = elastic.degrade(topo, dead, world_n=world_n)
        jdm = jelastic.degrade(jtopo, dead, world_n=world_n)
        assert (dm.dead, dm.live, dm.fingerprint, dm.team.members) == \
            (jdm.dead, jdm.live, jdm.fingerprint, jdm.team.members)
    assert elastic.degrade(None, [1], world_n=4).fingerprint == \
        "flat:n4:dead1"
    for fn in (elastic.degrade, jelastic.degrade):
        with pytest.raises(ValueError):
            fn(None, [1])
        with pytest.raises(ValueError, match="every PE"):
            fn(None, [0, 1], world_n=2)


def _toy_run(ctx, w, steps, mean, start=0, lr=0.05, ck=None, ckpt_every=2,
             drive_injector=False):
    """The reference's toy loop on the PGAS substrate: allreduce the
    'gradient', SGD step, loss = mean square.  Checkpoints the PRE-step
    state labeled with its step."""
    losses = []
    inj = ctx.fault_injector
    for step in range(start, steps):
        if drive_injector and inj is not None:
            inj.set_step(step)
        if ck is not None and step % ckpt_every == 0:
            ck.begin(step, {"w": w})
        g = ctx.to_all(w, "sum") / ctx.n_pes
        losses.append(mean(g * g))
        w = w - lr * g
    return losses, w


def test_kill_and_resume_sim_matches_uninterrupted_trajectory(tmp_path):
    steps = 9
    w0 = payload(w=8, seed=3)
    tmean = lambda t: float(t.mean())
    jmean = lambda a: float(jnp.mean(a))
    ref_losses, ref_w = _toy_run(sim_ctx(N, TOPO, device="cpu"),
                                 torch.from_numpy(w0), steps, tmean)
    jax_losses, _ = _toy_run(jsim_ctx(N, JTOPO), jnp.asarray(w0), steps,
                             jmean)
    np.testing.assert_allclose(ref_losses, jax_losses, **LOSS_TOL)

    # victim: checkpoint every 2 steps, PE 5 dies at step 5
    ctx = sim_ctx(N, TOPO, device="cpu", fault=FaultPlan().kill_pe(5, pe=5),
                  retry=RetryPolicy(**FAST))
    ck = PgasCheckpointer(ctx, tmp_path, async_issue=False)
    with pytest.raises(PEFailure) as ei:
        _toy_run(ctx, torch.from_numpy(w0), steps, tmean, ck=ck,
                 drive_injector=True)
    assert ei.value.pe == 5 and ei.value.step == 5
    ck.drain()                             # step 4's stream, issued alive
    dead = ctx.fault_injector.dead_pes
    step, state, dm = elastic.recover(ctx, dead, tmp_path,
                                      {"w": torch.zeros(N, 8)})
    jdm = jelastic.degrade(JTOPO, dead)
    assert step == 4 and dm.dead == (5,) and dm.live == jdm.live
    assert len(dm.live) == N - 1
    assert ctx._fp == dm.fingerprint == jdm.fingerprint  # re-keyed

    # resume on a healthy context from the restored step
    res_losses, res_w = _toy_run(sim_ctx(N, TOPO, device="cpu"),
                                 state["w"], steps, tmean, start=step)
    assert res_losses == ref_losses[step:]  # same ops on the same bits
    assert torch.equal(res_w, ref_w)
    np.testing.assert_allclose(res_losses, jax_losses[step:], **LOSS_TOL)


def test_recover_reports_to_profiler(tmp_path):
    prof = Profiler(level=1)
    ctx = sim_ctx(N, TOPO, device="cpu", profile=prof)
    ckpt.save(tmp_path, 7, {"w": torch.ones(N, 2)})
    step, state, dm = elastic.recover(ctx, [5, 9], tmp_path,
                                      {"w": torch.zeros(N, 2)})
    assert step == 7 and dm.dead == (5, 9)
    assert dm.fingerprint.endswith(":dead5,9")
    assert dm.fingerprint == jelastic.degrade(JTOPO, [5, 9]).fingerprint
    assert torch.equal(state["w"], torch.ones(N, 2))
    assert "fault.recovery_us" in prof.counters()
    assert "fault.recovered" in prof.counters()
    with pytest.raises(RuntimeError, match="rank process"):
        elastic.recover(ctx, [5], tmp_path, {"w": torch.zeros(N, 2)},
                        shardings={"w": None})


def test_recover_reshards_onto_fewer_rows(tmp_path):
    """A leaf saved at 16 rows restored into a template of 15: the
    reference's _reshard slice."""
    w = payload(w=3, seed=4)
    ckpt.save(tmp_path, 2, {"w": torch.from_numpy(w)})
    ctx = sim_ctx(N, TOPO, device="cpu")
    _, state, _ = elastic.recover(ctx, [5], tmp_path,
                                  {"w": torch.zeros(N - 1, 3)})
    same(state["w"].contiguous(), jckpt._reshard(w, (N - 1, 3), "w"))


# ---------------------------------------------------------------------------
# serving: graceful drain + re-queue on PE loss
# ---------------------------------------------------------------------------

KW = dict(max_slots=3, page_size=8, max_seq=32, prompt_bucket=16)
ARCH = "qwen2-0.5b"


def test_serve_pe_failure_drains_requeues_and_regenerates_bitwise():
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 1000, size=n).astype(np.int32)
               for n in (5, 9, 3, 7)]
    # the reference engine, faulted as its own test faults it
    jmetrics = JServeMetrics()
    jeng = JServeEngine(jax_smoke(ARCH, dtype=jnp.float32), make_mesh(1, 1),
                        capture_logits=True, metrics=jmetrics, **KW)
    jrids = [jeng.submit(p, 5) for p in prompts]
    jeng.step()
    real, shots = jeng._djit, {"n": 0}

    def dying_djit(*a, **k):
        if shots["n"] == 0:
            shots["n"] += 1
            raise jfault.PEFailure("PE 1 dropped off the NoC", pe=1, step=1)
        return real(*a, **k)

    jeng._djit = dying_djit
    jres = jeng.step()
    jeng.run()

    cfg = smoke_config(ARCH, dtype=torch.float32)
    metrics, tracer = ServeMetrics(), Tracer(level=LEVEL_FULL)
    eng = ServeEngine(cfg, device="cpu", capture_logits=True, metrics=metrics,
                      profile=tracer, params=params_from_jax(
                          jax.tree.map(np.asarray, jeng.params), cfg), **KW)
    rids = [eng.submit(p, 5) for p in prompts]
    eng.step()                             # admit three, 1 token in
    assert sorted(eng.scheduler.active_slots()) == [0, 1, 2]
    real_decode, calls = transformer.decode_step_paged, {"n": 0}

    def dying_decode(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:                # the second step's decode
            raise PEFailure("PE 1 dropped off the NoC", pe=1, step=1)
        return real_decode(*a, **k)

    with mock.patch.object(transformer, "decode_step_paged", dying_decode):
        res = eng.step()
        assert res["faulted"] and res["pe"] == 1 and res["decoded"] == 0
        assert res["requeued"] == jres["requeued"] == rids[:3]
        # FIFO preserved: queue head is back in slot (admission) order
        assert [r.rid for r in eng.scheduler.queue] == rids
        assert eng.scheduler.active_slots() == []
        assert eng.kv.pool.live_pages() == 0
        assert not eng.logits_trace
        assert metrics.pe_failures.value == jmetrics.pe_failures.value == 1
        assert metrics.requests_requeued.value == \
            jmetrics.requests_requeued.value == 3
        eng.run()
    assert sorted(eng.results) == sorted(rids)
    for r, jr in zip(rids, jrids):
        np.testing.assert_array_equal(eng.results[r], jeng.results[jr])
    drains = [e for e in tracer._events if e.get("name") ==
              "fault.serve_drain"]
    assert len(drains) == 1 and drains[0]["args"]["n_requeued"] == 3
    # a fault-free engine on the same weights gives the same tokens
    ref = ServeEngine(cfg, device="cpu", params=eng.params, **KW)
    for r, p in zip(rids, prompts):
        q = ref.submit(p, 5)
        ref.run()
        np.testing.assert_array_equal(eng.results[r], ref.results[q])


def test_serve_other_errors_still_propagate():
    eng = ServeEngine(smoke_config(ARCH, dtype=torch.float32), device="cpu",
                      **KW)
    eng.submit(np.arange(1, 6), 3)

    def broken(*a, **k):
        raise RuntimeError("not a PE failure")

    with mock.patch.object(transformer, "prefill_paged", broken):
        with pytest.raises(RuntimeError, match="not a PE failure"):
            eng.step()
