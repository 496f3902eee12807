"""The port's regression attribution and trace report
(`repro_torch.tools.perfdiff`, `repro_torch.tools.tracereport`) against
the JAX package's on the same documents: `BENCH_9.json` vs
`BENCH_10.json` (and injected regressions into BENCH_9, as
tests/test_perfdiff.py makes them), and two traces the reference's
tracer writes.  Reports, rendered text and CLI output must equal the
reference's character for character.  (`check_regression` belongs to
the reference's benchmark harness, which is not ported.)"""
import copy
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import Tracer as JTracer
from repro.core import epiphany3 as jepiphany3
from repro.core import sim_ctx as jsim_ctx
from repro.core.trace import LEVEL_FULL
from repro.serve.metrics import ServeMetrics as JServeMetrics
from repro.tools import perfdiff as jperfdiff
from repro.tools import tracereport as jtracereport
from repro_torch.tools import perfdiff, tracereport

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH9, BENCH10 = ROOT / "BENCH_9.json", ROOT / "BENCH_10.json"


@pytest.fixture(scope="module")
def base_doc():
    return json.loads(BENCH9.read_text())


def same_report(base, cur, **kw):
    rep = perfdiff.diff_bench(base, cur, **kw)
    want = jperfdiff.diff_bench(base, cur, **kw)
    assert rep == want
    assert perfdiff.render(rep) == jperfdiff.render(want)
    return rep


def test_bench9_vs_bench10_matches_the_reference():
    base = json.loads(BENCH9.read_text())
    cur = json.loads(BENCH10.read_text())
    for kw in ({}, dict(threshold=1.05, min_us=1.0),
               dict(threshold=1.01, min_us=0.5)):
        same_report(base, cur, **kw)
        same_report(cur, base, **kw)
    assert perfdiff.diff(BENCH9, BENCH10) == jperfdiff.diff(BENCH9, BENCH10)


def test_pick_change_attribution(base_doc):
    cur = copy.deepcopy(base_doc)
    for r in cur["rows"]:
        if (r["bench"], r["name"]) == ("congestion",
                                       "allreduce_ring_65536B"):
            r["measured_us"] *= 2.0
            r["picked"] = "ring/c1"
    rep = same_report(base_doc, cur)
    regs = {(e["bench"], e["name"]): e for e in rep["regressions"]}
    e = regs[("congestion", "allreduce_ring_65536B")]
    assert e["attribution"] == "pick"
    assert e["terms"]["pick"] == {"base": "ring_emb/c16", "cur": "ring/c1"}


def test_beta_shift_attribution(base_doc):
    cur = copy.deepcopy(base_doc)
    for r in cur["rows"]:
        if r["bench"] == "patterns" \
                and r["name"].startswith("allreduce_rd_") \
                and r.get("size_bytes"):
            r["measured_us"] *= 1.0 + r["size_bytes"] / 65536
    rep = same_report(base_doc, cur)
    regs = {(e["bench"], e["name"]): e for e in rep["regressions"]}
    e = regs[("patterns", "allreduce_rd_65536B")]
    assert e["attribution"] == "beta"
    assert e["terms"]["beta_us"] > abs(e["terms"]["alpha_us"])


def test_alpha_shift_attribution(base_doc):
    cur = copy.deepcopy(base_doc)
    for r in cur["rows"]:
        if r["bench"] == "patterns" \
                and r["name"].startswith("allreduce_rd_") \
                and r.get("size_bytes"):
            r["measured_us"] += 400.0
    rep = same_report(base_doc, cur)
    kinds = {e["attribution"] for e in rep["regressions"]
             if e["name"].startswith("allreduce_rd_")}
    assert "alpha" in kinds


def test_contention_shift_attribution(base_doc):
    base = copy.deepcopy(base_doc)
    for r in base["rows"]:
        if (r["bench"], r["name"]) == ("congestion", "contention_gamma"):
            r["derived"] = "gamma=0.40 (1.0=full serialization)"
        if r["bench"] == "congestion" \
                and r["name"].startswith("noc_stage_ring_offset"):
            r["measured_us"] *= 0.4
    rep = same_report(base, base_doc)
    assert rep["gamma_base"] == pytest.approx(0.40)
    assert rep["gamma_cur"] == pytest.approx(1.00)
    regs = {(e["bench"], e["name"]): e for e in rep["regressions"]}
    assert regs[("congestion", "noc_stage_ring_offset8")][
        "attribution"] == "contention"


def test_no_regressions_on_identical_docs_and_machine_banner(base_doc):
    rep = same_report(base_doc, base_doc)
    assert rep["regressions"] == [] and rep["n_rows_compared"] > 0
    a, b = copy.deepcopy(base_doc), copy.deepcopy(base_doc)
    a["machine"] = {"hostname": "runner-a", "cpus": 4}
    b["machine"] = {"hostname": "runner-b", "cpus": 64}
    rep = same_report(a, b)
    assert "DIFFERENT machines" in perfdiff.render(rep)


def test_doc_kind_and_mixed_diff_refused(tmp_path):
    assert perfdiff.doc_kind({"rows": []}) == "bench"
    assert perfdiff.doc_kind({"traceEvents": []}) == "trace"
    with pytest.raises(ValueError):
        perfdiff.doc_kind({})
    t = tmp_path / "t.json"
    t.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError, match="cannot diff"):
        perfdiff.diff(BENCH9, t)


# ---------------------------------------------------------------------------
# traces written by the reference's tracer
# ---------------------------------------------------------------------------

def _ref_trace(path, algorithm, width, metrics_path=None):
    t = JTracer(level=LEVEL_FULL)
    ctx = jsim_ctx(16, jepiphany3(), profile=t)
    x = jnp.asarray(np.random.RandomState(0).randn(16, width)
                    .astype(np.float32))
    ctx.to_all(x, algorithm=algorithm)
    ctx.fcollect(x[:, :16])
    with t.span("train_step", n_pes=16):
        ctx.broadcast(x, root=2)
    c = ctx.ctx_create()
    c.put_nbi(x, [(i, (i + 1) % 16) for i in range(16)])
    c.quiet()
    t.count("fault.retries", 2)
    t.instant("fault.retries", op="put")
    t.sections["roofline"] = {
        "machine": "test", "peaks": {"flops": 1e12, "mem_Bps": 1e11,
                                     "link_GBs": 2.4},
        "cells": [{"cell": "allreduce", "wall_us": 10.0, "compute_us": 1.0,
                   "memory_us": 2.0, "noc_us": 7.0, "bottleneck": "noc",
                   "mfu": 0.01}]}
    t.dump_chrome(path)
    if metrics_path is not None:
        m = JServeMetrics()
        m.attach(t)
        for rid in range(3):
            m.on_submit(rid)
            m.on_admit(rid)
            m.on_first_token(rid)
            m.on_decode_step(1, 1e-3 * (rid + 1))
            m.on_evict(rid)
        m.dump(metrics_path)


@pytest.fixture(scope="module")
def ref_traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("traces")
    a, b, m = d / "a.json", d / "b.json", d / "m.json"
    _ref_trace(a, "rd", 256, m)
    _ref_trace(b, "ring", 4096)
    return a, b, m


def test_trace_diff_matches_the_reference(ref_traces):
    a, b, _ = ref_traces
    da, db = json.loads(a.read_text()), json.loads(b.read_text())
    for top in (3, 10):
        rep = perfdiff.diff_traces(da, db, top=top)
        assert rep == jperfdiff.diff_traces(da, db, top=top)
        assert perfdiff.render(rep) == jperfdiff.render(rep)
    assert perfdiff.diff(a, b) == jperfdiff.diff(a, b)
    rep = perfdiff.diff_traces(da, db)
    assert rep["kind"] == "trace" and rep["spans"] and rep["stages"]
    assert "hottest-link" in perfdiff.render(rep)


def test_trace_diff_reports_span_and_link_shifts():
    def trace(dur, link_bytes):
        return {"traceEvents": [
            {"name": "allreduce[ring]", "ph": "X", "ts": 0.0,
             "dur": dur, "pid": 1, "tid": 0, "cat": "collective"},
            {"name": "allreduce.ring.s0", "ph": "X", "ts": 0.0,
             "dur": dur / 2, "pid": 0, "tid": 0, "cat": "stage"},
        ], "repro": {"schema": 1, "heatmap": [
            {"shape": [4, 4], "n_links": 1, "links": [
                {"a": 0, "b": 1, "bytes": link_bytes,
                 "coord_a": [0, 0], "coord_b": [0, 1]}]}]}}

    rep = perfdiff.diff_traces(trace(100.0, 1e6), trace(250.0, 4e6))
    assert rep == jperfdiff.diff_traces(trace(100.0, 1e6),
                                        trace(250.0, 4e6))
    spans = {d["name"]: d for d in rep["spans"]}
    assert spans["allreduce[ring]"]["delta_us"] == pytest.approx(150.0)
    stages = {d["name"]: d for d in rep["stages"]}
    assert stages["allreduce.ring.s0"]["delta_us"] == pytest.approx(75.0)
    assert rep["hot_links"][0]["cur_bytes"] == pytest.approx(4e6)


def _out(main, argv, capsys):
    main(argv)
    return capsys.readouterr()


@pytest.mark.parametrize("argv", [
    ["{a}"], ["{a}", "--metrics", "{m}"], ["{a}", "--metrics", "{m}",
                                          "--check", "--top", "3"],
    ["{b}", "--diff", "{a}"], ["{a}", "--diff", "{b}", "--top", "2"]],
    ids=["report", "metrics", "check", "diff", "diff-top2"])
def test_tracereport_cli_matches_the_reference(ref_traces, capsys, argv):
    a, b, m = ref_traces
    argv = [s.format(a=a, b=b, m=m) for s in argv]
    got = _out(tracereport.main, argv, capsys)
    want = _out(jtracereport.main, argv, capsys)
    assert got.out == want.out and got.err == want.err
    assert got.out


def test_tracereport_check_fails_on_corruption(ref_traces, tmp_path,
                                               capsys):
    a, _, m = ref_traces
    doc = json.loads(a.read_text())
    doc["traceEvents"].append({"ph": "X", "name": "bad"})
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    codes = []
    for main in (tracereport.main, jtracereport.main):
        with pytest.raises(SystemExit) as e:
            main([str(bad), "--metrics", str(m), "--check"])
        codes.append((e.value.code, capsys.readouterr().err))
    assert codes[0] == codes[1] and codes[0][0] == 1
    assert tracereport.validate_trace(doc) == \
        jtracereport.validate_trace(doc)


def test_perfdiff_cli_matches_the_reference(ref_traces, tmp_path, capsys):
    a, b, _ = ref_traces
    for base, cur in ((BENCH9, BENCH10), (a, b)):
        outs = []
        for i, main in enumerate((perfdiff.main, jperfdiff.main)):
            js = tmp_path / f"rep{i}.json"
            main([str(base), str(cur), "--threshold", "1.1", "--top", "4",
                  "--json", str(js)])
            outs.append((capsys.readouterr().out, js.read_text()))
        assert outs[0] == outs[1]
