"""The port's observability layer (`repro_torch.core.trace`,
`repro_torch.serve.metrics`, the engine's spans and request track, the
launchers' document flags) against the JAX package's, on the CPU, on the
same numpy inputs.  Mirrors tests/test_trace.py.

Compared exactly: Chrome event sequences apart from ``ts``/``dur``,
counters apart from times, heatmaps, `MetricsRegistry.to_json` after the
same observations, and the engine's tokens and lifecycle counts on the
same weights.  Each package's `validate_trace`/`validate_metrics` accepts
the other's documents.  The two jit-only reference tests get CPU
counterparts that patch `trace_clean` to stand for CUDA-graph capture."""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import smoke_config as jsmoke_config
from repro.core import Profiler as JProfiler
from repro.core import Tracer as JTracer
from repro.core import epiphany3 as jepiphany3
from repro.core import sim_ctx as jsim_ctx
from repro.core.fault import fault_event as jfault_event
from repro.launch import serve as jserve_launch
from repro.launch.mesh import make_mesh
from repro.serve import engine as jengine_mod
from repro.serve.metrics import Histogram as JHistogram
from repro.serve.metrics import MetricsRegistry as JMetricsRegistry
from repro.serve.metrics import ServeMetrics as JServeMetrics
from repro.tools.tracereport import validate_metrics as jvalidate_metrics
from repro.tools.tracereport import validate_trace as jvalidate_trace
from repro_torch import configs as port_configs
from repro_torch.configs import smoke_config
from repro_torch.core import Profiler, Tracer, abmodel, epiphany3, sim_ctx
from repro_torch.core import profile as profile_mod
from repro_torch.core import shmem as shmem_mod
from repro_torch.core.fault import fault_event
from repro_torch.core.trace import LEVEL_FULL, PID_HOST, PID_PE
from repro_torch.launch import serve as serve_launch
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv import PagePool
from repro_torch.serve.metrics import (Histogram, MetricsRegistry,
                                       ServeMetrics)
from repro_torch.tools import tracereport
from repro_torch.tools.tracereport import validate_metrics, validate_trace

ARCH = "qwen2-0.5b"


def _events(t, **match):
    return [e for e in t._events
            if all(e.get(k) == v for k, v in match.items())]


def _untimed(evs):
    """Events without their times: ``ts``/``dur``, a sync span's
    issue/stall split, and the stall child span (present when the
    measured stall is above zero)."""
    out = []
    for e in evs:
        if e.get("cat") == "stall":
            continue
        e = {k: v for k, v in e.items() if k not in ("ts", "dur")}
        if "args" in e:
            e["args"] = {k: v for k, v in e["args"].items()
                         if k not in ("issue_us", "stall_us")}
        out.append(e)
    return out


def _counters(p):
    return {k: {kk: vv for kk, vv in v.items()
                if kk not in ("total_s", "issue_s", "stall_s")}
            for k, v in p.counters().items()}


def _np(n, w, seed=0):
    return np.random.RandomState(seed).randn(n, w).astype(np.float32)


def _both(fn_port, fn_ref, **kw):
    """Run the same sequence on a port Tracer and a reference Tracer."""
    t, jt = Tracer(**kw), JTracer(**kw)
    fn_port(t)
    fn_ref(jt)
    return t, jt


def assert_same_trace(t, jt):
    assert _untimed(t.to_chrome()["traceEvents"]) == \
        _untimed(jt.to_chrome()["traceEvents"])
    assert _counters(t) == _counters(jt)
    assert t.heatmap() == jt.heatmap()
    assert t.events_dropped == jt.events_dropped


# ---------------------------------------------------------------------------
# Tracer: levels, spans, chrome export
# ---------------------------------------------------------------------------

def test_disabled_tracer_records_nothing():
    t = Tracer(level=0)
    with t.span("x") as s:
        assert s is None
    t.instant("i")
    t.begin_async("req", 1, "r")
    t.end_async("req", 1, "r")
    assert t._events == [] and t.samples == []


def test_span_nesting_and_meta_args():
    def run(t):
        with t.span("outer"):
            with t.span("inner", nbytes=64.0, custom="tag"):
                pass
    t, jt = _both(run, run, level=2)
    names = [e["name"] for e in _events(t, ph="X")]
    assert names == ["inner", "outer"]
    inner, outer = _events(t, ph="X")
    assert inner["args"]["custom"] == "tag"
    assert inner["args"]["nbytes"] == 64.0
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    assert_same_trace(t, jt)


def test_device_span_waits_and_keeps_meta(monkeypatch):
    waits = []
    monkeypatch.setattr(profile_mod, "wait_device", waits.append)
    t = Tracer(level=2)
    with t.span("serve.decode", n_pes=2, device=torch.device("cpu"),
                custom=1):
        pass
    assert waits == [torch.device("cpu")] * 2
    assert _events(t, ph="X")[0]["args"]["custom"] == 1


def test_level1_counts_but_no_events():
    def run(t):
        with t.span("x"):
            pass
        t.instant("i")
    t, jt = _both(run, run, level=1)
    assert t._events == [] and "span.x" in t.counters()
    assert_same_trace(t, jt)


def test_async_request_track_roundtrip():
    def run(t):
        t.begin_async("request", 7, "req 7", prompt_len=5)
        t.instant_async("request", 7, "admit")
        t.end_async("request", 7, "req 7", n_tokens=3)
    t, jt = _both(run, run, level=2)
    assert [e["ph"] for e in _events(t, cat="request")] == ["b", "n", "e"]
    assert validate_trace(t.to_chrome()) == []
    assert jvalidate_trace(t.to_chrome()) == []
    assert_same_trace(t, jt)


def _collectives(ctx, x, xf):
    ctx.to_all(x, algorithm="rd")
    ctx.to_all(x, algorithm="ring", pipeline_chunks=2)
    ctx.fcollect(xf)
    ctx.broadcast(x, root=5)
    ctx.barrier(algorithm="tree")
    c = ctx.ctx_create()
    c.put_nbi(x, [(i, (i + 1) % 16) for i in range(16)])
    c.fence()
    c.quiet()


@pytest.mark.parametrize("noc", [False, True], ids=["sim", "noc"])
def test_eager_collective_renders_stages_flows_heatmap(noc):
    x = _np(16, 256)
    t, jt = Tracer(level=LEVEL_FULL), JTracer(level=LEVEL_FULL)
    _collectives(sim_ctx(16, epiphany3(), noc=noc, device="cpu", profile=t),
                 torch.from_numpy(x), torch.from_numpy(x[:, :64]))
    _collectives(jsim_ctx(16, jepiphany3(), noc=noc, profile=jt),
                 jnp.asarray(x), jnp.asarray(x[:, :64]))
    ops = _events(t, ph="X", pid=PID_HOST)
    assert any(e["name"] == "allreduce[rd]" for e in ops)
    rd = [e for e in _events(t, cat="stage")
          if e["name"].startswith("allreduce.rd")]
    assert len(rd) == 4 * 16
    assert {e["tid"] for e in rd} == set(range(16))
    assert {e["pid"] for e in rd} == {PID_PE}
    starts = {e["id"]: e for e in _events(t, ph="s")}
    finishes = {e["id"]: e for e in _events(t, ph="f")}
    assert starts and set(starts) == set(finishes)
    for fid, s in starts.items():
        assert s["tid"] != finishes[fid]["tid"]
    hm = t.heatmap()
    assert len(hm) == 1 and hm[0]["shape"] == [4, 4]
    assert hm[0]["links"][0]["bytes"] == hm[0]["max_bytes"] > 0
    doc = t.to_chrome()
    assert validate_trace(doc) == [] and jvalidate_trace(doc) == []
    assert_same_trace(t, jt)


def test_flow_cap_bounds_events():
    t = Tracer(level=LEVEL_FULL, flows_per_op=3)
    ctx = sim_ctx(16, epiphany3(), device="cpu", profile=t)
    ctx.to_all(torch.ones((16, 64)), algorithm="ring")
    assert len(_events(t, ph="s")) <= 3


def test_event_cap_counts_drops():
    def run(t):
        for i in range(5):
            t.instant(f"i{i}")
    t, jt = _both(run, run, level=2, max_events=2)
    assert len(t._events) == 2 and t.events_dropped == 3
    assert_same_trace(t, jt)


@pytest.fixture
def capturing(monkeypatch):
    """Stand in for CUDA-graph capture / torch.compile tracing."""
    for mod in (profile_mod, shmem_mod):
        monkeypatch.setattr(mod, "trace_clean", lambda: False)
    waits = []
    monkeypatch.setattr(profile_mod, "wait_device",
                        lambda d: waits.append(d) if d is not None else None)
    return waits


def test_traced_collective_uses_predicted_duration(capturing):
    """A collective recorded under capture has no execution interval:
    it never waits on the device, and its stage spans stretch over the
    modeled time, flagged traced."""
    t = Tracer(level=LEVEL_FULL)
    ctx = sim_ctx(16, epiphany3(), device="cpu", profile=t)
    ctx.to_all(torch.ones((16, 256)), algorithm="rd")
    stages = _events(t, cat="stage")
    assert stages and all(e["dur"] > 0 for e in stages)
    assert all(e["args"].get("traced") for e in stages)
    # with a link model, the stage spans add up to the modeled time
    t2 = Tracer(level=LEVEL_FULL)
    ctx2 = sim_ctx(16, epiphany3(), device="cpu", profile=t2,
                   link=abmodel.EPIPHANY_NOC)
    ctx2.to_all(torch.ones((16, 256)), algorithm="rd")
    pred = t2.samples[0].predicted_s
    assert pred > 0
    assert sum(e["dur"] for e in _events(t2, cat="stage")
               if e["tid"] == 0) == pytest.approx(pred * 1e6)
    assert capturing == []                       # no device wait
    tuner_db = []
    t.add_sink(lambda s: tuner_db.append(s.traced))
    ctx.to_all(torch.ones((16, 256)), algorithm="rd")
    assert tuner_db == [True]


# ---------------------------------------------------------------------------
# quiet/fence stall attribution
# ---------------------------------------------------------------------------

def test_quiet_splits_stall_from_issue():
    prof = Profiler(level=2)
    ctx = sim_ctx(4, device="cpu", profile=prof)
    c = ctx.ctx_create()
    c.put_nbi(torch.ones((4, 128)), [(i, (i + 1) % 4) for i in range(4)])
    c.quiet()
    sync = [s for s in prof.samples if s.kind == "sync"]
    assert len(sync) == 1 and sync[0].collective == "quiet"
    s = sync[0]
    assert s.issue_s > 0 and s.stall_s >= 0
    assert s.wall_s == pytest.approx(s.issue_s + s.stall_s)
    c2 = prof.counters()["sync.quiet"]
    assert c2["issue_s"] == pytest.approx(s.issue_s)
    assert c2["stall_s"] == pytest.approx(s.stall_s)
    assert s.meta == {"n_ops": 1}


def test_fence_reports_issue_only():
    prof = Profiler(level=2)
    ctx = sim_ctx(4, device="cpu", profile=prof)
    c = ctx.ctx_create()
    c.put_nbi(torch.ones((4, 32)), [(i, (i + 1) % 4) for i in range(4)])
    c.fence()
    sync = [s for s in prof.samples if s.kind == "sync"]
    assert len(sync) == 1 and sync[0].collective == "fence"
    assert sync[0].issue_s > 0 and sync[0].stall_s == 0.0
    assert len(c.quiet()) == 1        # queue still drains after the fence


def test_quiet_sync_renders_stall_child_span():
    t = Tracer(level=2)
    ctx = sim_ctx(4, device="cpu", profile=t)
    c = ctx.ctx_create()
    c.put_nbi(torch.ones((4, 4096)), [(i, (i + 1) % 4) for i in range(4)])
    c.quiet()
    qevs = _events(t, ph="X", cat="sync")
    assert len(qevs) == 1
    a = qevs[0]["args"]
    assert a["issue_us"] >= 0 and a["stall_us"] >= 0
    stall = _events(t, cat="stall")
    if a["stall_us"] > 0:
        assert len(stall) == 1
        assert stall[0]["ts"] == pytest.approx(qevs[0]["ts"] + a["issue_us"])


def test_quiet_untimed_inside_capture(capturing):
    """Under capture, quiet must not wait on the device and records no
    sync sample (the reference's test_quiet_untimed_inside_jit)."""
    prof = Profiler(level=2)
    ctx = sim_ctx(4, device="cpu", profile=prof)
    c = ctx.ctx_create()
    c.put_nbi(torch.ones((4, 16)), [(i, (i + 1) % 4) for i in range(4)])
    (v,) = c.quiet()
    assert v.shape == (4, 16)
    assert not any(s.kind == "sync" for s in prof.samples)
    assert capturing == []


# ---------------------------------------------------------------------------
# sink hardening + mid-run pcontrol transitions
# ---------------------------------------------------------------------------

def test_raising_sink_does_not_abort_op_and_is_dropped():
    prof = Profiler(level=2)
    good: list = []

    def bad_sink(s):
        raise RuntimeError("observer bug")

    prof.add_sink(bad_sink)
    prof.add_sink(good.append)
    for i in range(5):
        with prof.op(f"op{i}"):
            pass
    assert len(good) == 5 and len(prof.samples) == 5
    assert prof.sink_errors == Profiler.SINK_MAX_FAILURES
    assert prof.sinks_dropped == 1
    assert bad_sink not in prof._sinks and good.append in prof._sinks
    j = prof.to_json()
    assert j["sink_errors"] == Profiler.SINK_MAX_FAILURES
    assert j["sinks_dropped"] == 1


def test_flaky_sink_survives_with_consecutive_reset():
    prof = Profiler(level=1)
    calls = {"n": 0}

    def flaky(s):
        calls["n"] += 1
        if calls["n"] % 2:
            raise ValueError("flaky")

    prof.add_sink(flaky)
    for i in range(6):
        with prof.op("x"):
            pass
    assert prof.sinks_dropped == 0 and flaky in prof._sinks
    assert prof.sink_errors == 3


def test_pcontrol_transition_while_op_open():
    for P in (Profiler, JProfiler):
        prof = P(level=2)
        with prof.op("a") as s:
            assert s is not None
            prof.pcontrol(0)
        assert prof.samples == [] and prof.counters() == {}
        with prof.op("b") as s:
            assert s is None
            prof.pcontrol(2)
        assert prof.samples == []
        with prof.op("c"):
            pass
        assert [s.collective for s in prof.samples] == ["c"]


def test_pcontrol_toggle_during_eager_collectives():
    prof = Profiler(level=2)
    ctx = sim_ctx(8, device="cpu", profile=prof)
    x = torch.ones((8, 64))
    ctx.to_all(x)
    prof.pcontrol(0)
    ctx.to_all(x)
    prof.pcontrol(2)
    ctx.to_all(x)
    assert len([s for s in prof.samples if s.kind == "collective"]) == 2


def test_fault_event_counts_and_marks_an_instant():
    def run(fe):
        def go(t):
            fe(t, "fault.retries", op="put", attempt=1)
            fe(t, "fault.retries", n=2, op="get", attempt=2)
            fe(None, "fault.retries")
        return go
    t, jt = Tracer(level=2), JTracer(level=2)
    run(fault_event)(t)
    run(jfault_event)(jt)
    assert t.counters()["fault.retries"]["count"] == 3
    assert len(_events(t, ph="i")) == 2
    assert_same_trace(t, jt)
    p, jp = Profiler(level=2), JProfiler(level=2)
    run(fault_event)(p)
    run(jfault_event)(jp)
    assert _counters(p) == _counters(jp)
    off = Profiler(level=0)
    fault_event(off, "fault.retries")
    assert off.counters() == {}


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_histogram_buckets_and_percentiles():
    for H in (Histogram, JHistogram):
        h = H("lat", lo=1e-4, hi=1.0, n_buckets=8)
        for v in (1e-5, 1e-3, 1e-2, 0.5, 2.0):
            h.observe(v)
        assert h.count == 5
        assert h.buckets[0] == 1 and h.buckets[-1] == 1
        assert sum(h.buckets) == h.count
        assert h.percentile(50) == 1e-2
        assert h.percentile(0) == 1e-5 and h.percentile(100) == 2.0
        assert h.mean == pytest.approx(sum((1e-5, 1e-3, 1e-2, 0.5, 2.0)) / 5)
        assert math.isnan(H("e").percentile(50))
    a, b = Histogram("x", n_buckets=12), JHistogram("x", n_buckets=12)
    for v in np.random.RandomState(0).lognormal(-6, 3, 300):
        a.observe(v)
        b.observe(v)
    assert a.to_json() == b.to_json()
    assert a.bucket_edges() == b.bucket_edges()


def _fill_registry(r):
    r.counter("c", "a counter").inc(3)
    r.counter("c").inc(0.5)
    r.gauge("g").set(1.5)
    r.gauge("g").set(-2)
    r.gauge("unset")
    r.histogram("h", lo=1e-3, hi=10.0, n_buckets=5).observe(0.25)
    r.histogram("empty")


def test_registry_types_and_export(tmp_path):
    r, jr = MetricsRegistry(), JMetricsRegistry()
    _fill_registry(r)
    _fill_registry(jr)
    assert r.counter("c") is r["c"] and "g" in r
    with pytest.raises(TypeError):
        r.gauge("c")
    assert r.to_json() == jr.to_json() and r.names() == jr.names()
    p = tmp_path / "sub" / "m.json"
    r.dump(p)
    doc = json.loads(p.read_text())
    assert "NaN" not in p.read_text()
    assert validate_metrics(doc) == [] and jvalidate_metrics(doc) == []
    assert doc["metrics"]["c"]["value"] == 3.5
    assert doc["metrics"]["g"]["min"] == -2
    assert doc["metrics"]["h"]["count"] == 1


def test_serve_metrics_lifecycle_math():
    def drive(m):
        m.on_submit(0)
        m.on_submit(1)
        m.on_admit(0)
        m.on_first_token(0)
        m.on_decode_step(1, 0.002)
        m.on_decode_step(1, 0.004)
        m.on_evict(0)
        m.on_backpressure()
        m.on_pe_failure(2, 0.01)
        return m
    m, jm = drive(ServeMetrics()), drive(JServeMetrics())
    assert m.requests_completed.value == 1
    assert m.tokens_generated.value == 3
    assert m.ttft_s.count == 1 and m.e2e_s.count == 1
    assert m.per_token_s.percentile(50) in (0.002, 0.004)
    assert m.backpressure_waits.value == 1
    assert list(m._submit_t) == [1]

    def untimed(doc):
        return {k: (v if v["type"] != "histogram" else
                    {kk: vv for kk, vv in v.items()
                     if kk in ("count", "type", "help", "bucket_lo",
                               "bucket_hi")})
                for k, v in doc["metrics"].items()}
    assert untimed(m.to_json()) == untimed(jm.to_json())
    assert m.per_token_s.to_json() == jm.per_token_s.to_json()


def test_pagepool_occupancy_fragmentation():
    pool = PagePool(8 * 4096, 4096)
    assert pool.occupancy() == 0.0 and pool.fragmentation() == 0.0
    got = pool.alloc(3)
    assert pool.occupancy() == pytest.approx(3 / 7)
    pool.free([got[-1]])
    assert pool.fragmentation() == pytest.approx(1 / 5)
    pool.free(reversed(got[:-1]))
    assert pool.occupancy() == 0.0 and pool.fragmentation() == 0.0


# ---------------------------------------------------------------------------
# engine + launcher integration, against the reference on the same weights
# ---------------------------------------------------------------------------

KW = dict(max_slots=2, page_size=8, max_seq=32, prompt_bucket=16)
LENS = (5, 9, 3)


@pytest.fixture(scope="module")
def traced_engine_run():
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, size=n, dtype=np.int32) for n in LENS]
    jtracer, jmetrics = JTracer(level=LEVEL_FULL), JServeMetrics()
    jmetrics.attach(jtracer)
    jeng = jengine_mod.ServeEngine(
        jsmoke_config(ARCH, dtype=jnp.float32), make_mesh(1, 1),
        profile=jtracer, metrics=jmetrics, **KW)
    jrids = [jeng.submit(p, 4) for p in prompts]
    jeng.run()
    tracer, metrics = Tracer(level=LEVEL_FULL), ServeMetrics()
    metrics.attach(tracer)
    cfg = smoke_config(ARCH, dtype=torch.float32)
    eng = ServeEngine(cfg, device="cpu", profile=tracer, metrics=metrics,
                      params=params_from_jax(
                          jax.tree.map(np.asarray, jeng.params), cfg), **KW)
    rids = [eng.submit(p, 4) for p in prompts]
    eng.run()
    return (eng, tracer, metrics, rids), (jeng, jtracer, jmetrics, jrids)


def test_engine_emits_request_lifecycle(traced_engine_run):
    (eng, tracer, metrics, rids), (jeng, jtracer, _, jrids) = \
        traced_engine_run
    for r, jr in zip(rids, jrids):
        np.testing.assert_array_equal(eng.results[r], jeng.results[jr])
    req = [e for e in tracer._events if e.get("cat") == "request"]
    begins = [e for e in req if e["ph"] == "b"]
    ends = [e for e in req if e["ph"] == "e"]
    assert len(begins) == len(rids) and len(ends) == len(rids)
    assert {e["id"] for e in begins} == {str(r) for r in rids}
    assert {"admit", "first_token"} <= {e["name"] for e in req
                                         if e["ph"] == "n"}
    spans = {e["name"] for e in tracer._events if e.get("ph") == "X"}
    assert {"serve.step", "serve.prefill", "serve.decode"} <= spans
    # the whole event sequence is the reference's, apart from times
    assert_same_trace(tracer, jtracer)


def test_engine_metrics_consistent(traced_engine_run):
    (eng, tracer, metrics, rids), (_, _, jmetrics, _) = traced_engine_run
    n = len(rids)
    assert metrics.requests_submitted.value == n
    assert metrics.requests_completed.value == n
    assert metrics.ttft_s.count == n and metrics.e2e_s.count == n
    assert metrics.tokens_generated.value == 4 * n
    assert metrics.kv_pages_live.value == 0
    assert metrics.kv_occupancy.value == 0.0
    doc, jdoc = metrics.to_json(), jmetrics.to_json()
    assert validate_metrics(doc) == [] and jvalidate_metrics(doc) == []
    assert validate_metrics(jdoc) == []
    assert "heatmap" in doc and "wire" in doc
    for name, m in doc["metrics"].items():
        jm = jdoc["metrics"][name]
        if m["type"] == "histogram":
            assert m["count"] == jm["count"], name
        else:
            assert m == jm, name
    assert doc["wire"].keys() == jdoc["wire"].keys()


def test_trace_document_validates(traced_engine_run, tmp_path):
    (_, tracer, _, _), (_, jtracer, _, _) = traced_engine_run
    p, jp = tmp_path / "trace.json", tmp_path / "jtrace.json"
    tracer.dump_chrome(p)
    jtracer.dump_chrome(jp)
    doc, jdoc = json.loads(p.read_text()), json.loads(jp.read_text())
    for d in (doc, jdoc):
        assert validate_trace(d) == [] and jvalidate_trace(d) == []
    assert doc["repro"]["level"] == LEVEL_FULL
    assert sorted(doc["repro"]) == sorted(jdoc["repro"])


def test_tracereport_cli(traced_engine_run, tmp_path, capsys):
    (_, tracer, metrics, _), _ = traced_engine_run
    tp, mp = tmp_path / "t.json", tmp_path / "m.json"
    tracer.dump_chrome(tp)
    metrics.dump(mp)
    tracereport.main([str(tp), "--metrics", str(mp), "--check"])
    out = capsys.readouterr().out
    assert "schema check OK" in out
    assert "serve.step" in out and "serve.per_token_s" in out


def test_validate_catches_corruption(traced_engine_run):
    (_, tracer, _, _), _ = traced_engine_run
    doc = tracer.to_chrome()
    doc["traceEvents"].append({"ph": "X", "name": "bad"})
    assert validate_trace(doc) == jvalidate_trace(doc) != []
    for bad in ({"schema": 2, "metrics": {}},
                {"schema": 1, "metrics": {"x": {"type": "wat"}}},
                {"schema": 1, "metrics": {"h": {
                    "type": "histogram", "count": 2, "buckets": [1]}}},
                [], {"traceEvents": []}):
        assert validate_metrics(bad) == jvalidate_metrics(bad) != []
        assert validate_trace(bad) == jvalidate_trace(bad)


def test_launch_serve_trace_flags(tmp_path):
    tout, mout = tmp_path / "trace.json", tmp_path / "metrics.json"
    pout, dbout = tmp_path / "profile.json", tmp_path / "db.json"
    serve_launch.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
        "--prompt-len", "8", "--tokens", "4", "--trace-out", str(tout),
        "--metrics-out", str(mout), "--profile-out", str(pout),
        "--autotune", "--tuning-db", str(dbout)])
    tdoc, mdoc = json.loads(tout.read_text()), json.loads(mout.read_text())
    assert validate_trace(tdoc) == [] and jvalidate_trace(tdoc) == []
    assert validate_metrics(mdoc) == [] and jvalidate_metrics(mdoc) == []
    assert mdoc["metrics"]["serve.requests_completed"]["value"] == 2
    assert json.loads(pout.read_text())["schema"] == 1
    assert json.loads(dbout.read_text()) == {"schema": 1, "entries": {},
                                             "links": {}}


def _capture_ref_engine(monkeypatch):
    made = []

    class Recording(jengine_mod.ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jengine_mod, "ServeEngine", Recording)
    return made


# 5120 B holds the null page and 4 pages of 1024 B (the f32 smoke
# config at page 4): one 3-page request at a time, so the second slot's
# admission waits on pages
@pytest.mark.parametrize("extra", [
    ["--continuous", "--requests", "5", "--rate", "2"],
    ["--continuous", "--requests", "4", "--rate", "1",
     "--kv-heap-bytes", "5120"]], ids=["rate2", "backpressure"])
def test_launch_serve_continuous_matches_the_reference(monkeypatch, tmp_path,
                                                       extra):
    """--continuous on the smoke config (in f32, on the reference's
    weights): token for token the reference launcher's output, with
    equal request/token/backpressure counters."""
    args = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "6",
            "--tokens", "3", "--page-size", "4"] + extra
    monkeypatch.setattr(
        jconfigs, "smoke_config",
        lambda a, **kw: jsmoke_config(a, dtype=jnp.float32, **kw))
    made = _capture_ref_engine(monkeypatch)
    jm = tmp_path / "jm.json"
    want = jserve_launch.main(args + ["--metrics-out", str(jm)])
    (jeng,) = made
    tree = jax.tree.map(np.asarray, jeng.params)

    monkeypatch.setattr(port_configs, "smoke_config",
                        lambda a, **kw: smoke_config(a, dtype=torch.float32,
                                                     **kw))

    class Seeded(ServeEngine):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, params=params_from_jax(tree, cfg), **kw)

    monkeypatch.setattr(engine_mod, "ServeEngine", Seeded)
    pm = tmp_path / "pm.json"
    got = serve_launch.main(args + ["--device", "cpu", "--metrics-out",
                                    str(pm)])
    np.testing.assert_array_equal(got, want)
    doc, jdoc = json.loads(pm.read_text()), json.loads(jm.read_text())
    for name in ("serve.requests_submitted", "serve.requests_admitted",
                 "serve.requests_completed", "serve.tokens_generated",
                 "serve.prefill_runs", "serve.decode_steps",
                 "serve.engine_steps", "serve.backpressure_waits"):
        assert doc["metrics"][name] == jdoc["metrics"][name], name
    assert doc["metrics"]["serve.requests_completed"]["value"] == \
        int(extra[2])
    if "--kv-heap-bytes" in extra:
        assert doc["metrics"]["serve.backpressure_waits"]["value"] > 0
