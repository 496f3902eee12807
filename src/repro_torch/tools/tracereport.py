"""Text summary of a Chrome trace produced by `Tracer.dump_chrome` (port
of `repro/tools/tracereport.py`, DESIGN.md §16) — the "where did the time
go" view without opening ui.perfetto.dev: top spans by total wall
time, quiet/fence stall fractions, the hottest NoC links as an ASCII
heatmap, and (with ``--metrics``) the serving latency percentiles.

``--check`` validates both documents against the expected schema
(hand-rolled structural checks, no external jsonschema dependency) and
exits non-zero on violations — the CI artifact gate.  ``--diff OTHER``
prints the per-span/per-stage wall deltas and hottest-link shifts
against a second trace (``repro_torch.tools.perfdiff``); a trace whose
``repro`` section embeds a ``roofline`` summary (benchmarks/roofline.py)
gets an MFU/bottleneck section.

The report and the check read documents of either package: the schemas
are shared.

  PYTHONPATH=src python -m repro_torch.tools.tracereport trace.json \\
      --metrics metrics.json --check
  PYTHONPATH=src python -m repro_torch.tools.tracereport new.json \\
      --diff old.json
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys


# ---------------------------------------------------------------------------
# schema validation (the CI --check gate)
# ---------------------------------------------------------------------------

_EVENT_PHASES = {"X", "B", "E", "i", "I", "s", "t", "f", "b", "n", "e",
                 "M", "C"}


def validate_trace(doc: dict) -> list[str]:
    """Structural check of a Chrome trace-event JSON-object document.
    Returns a list of violations (empty == valid)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing/invalid traceEvents array"]
    if not evs:
        errs.append("traceEvents is empty")
    open_async: dict[tuple, int] = {}
    flows: dict[object, list[str]] = {}
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _EVENT_PHASES:
            errs.append(f"event {i}: bad ph {ph!r}")
            continue
        if "name" not in ev:
            errs.append(f"event {i}: missing name")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                errs.append(f"event {i}: missing/invalid ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            errs.append(f"event {i}: X event without dur")
        if ph in ("b", "n", "e"):
            key = (ev.get("cat"), ev.get("id"), ev.get("name"))
            if ph == "b":
                open_async[key] = open_async.get(key, 0) + 1
            elif ph == "e":
                if open_async.get(key, 0) <= 0:
                    errs.append(f"event {i}: async end without begin {key}")
                else:
                    open_async[key] -= 1
        if ph in ("s", "f"):
            flows.setdefault(ev.get("id"), []).append(ph)
    for key, n in open_async.items():
        if n:
            errs.append(f"unclosed async span {key}")
    for fid, phs in flows.items():
        if "s" in phs and "f" not in phs:
            errs.append(f"flow {fid}: start without finish")
        if "f" in phs and "s" not in phs:
            errs.append(f"flow {fid}: finish without start")
    rep = doc.get("repro")
    if rep is not None:
        if not isinstance(rep, dict) or rep.get("schema") != 1:
            errs.append("repro section present but schema != 1")
        elif not isinstance(rep.get("counters", {}), dict):
            errs.append("repro.counters is not an object")
    return errs


def validate_metrics(doc: dict) -> list[str]:
    """Structural check of a MetricsRegistry JSON document."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    if doc.get("schema") != 1:
        errs.append("schema != 1")
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict):
        return errs + ["missing/invalid metrics object"]
    for name, m in metrics.items():
        t = m.get("type") if isinstance(m, dict) else None
        if t not in ("counter", "gauge", "histogram"):
            errs.append(f"{name}: bad type {t!r}")
            continue
        if t in ("counter", "gauge") and \
                not isinstance(m.get("value"), (int, float, type(None))):
            errs.append(f"{name}: missing value")
        if t == "histogram":
            if not isinstance(m.get("count"), int):
                errs.append(f"{name}: histogram without count")
            b = m.get("buckets")
            if not (isinstance(b, list)
                    and all(isinstance(x, int) for x in b)):
                errs.append(f"{name}: invalid buckets")
            elif isinstance(m.get("count"), int) and sum(b) != m["count"]:
                errs.append(f"{name}: bucket sum {sum(b)} != count "
                            f"{m['count']}")
    return errs


# ---------------------------------------------------------------------------
# report rendering
# ---------------------------------------------------------------------------

def _top_spans(evs: list[dict], top: int) -> list[tuple[str, float, int]]:
    agg: dict[str, list[float]] = {}
    for ev in evs:
        if ev.get("ph") == "X" and ev.get("pid") == 1:
            agg.setdefault(ev["name"], [0.0, 0])
            agg[ev["name"]][0] += float(ev.get("dur", 0.0))
            agg[ev["name"]][1] += 1
    rows = [(n, tot, int(cnt)) for n, (tot, cnt) in agg.items()]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


def _stall_report(evs: list[dict]) -> list[str]:
    lines = []
    for ev in evs:
        if ev.get("cat") != "sync" or ev.get("ph") != "X":
            continue
        a = ev.get("args", {})
        issue, stall = a.get("issue_us", 0.0), a.get("stall_us", 0.0)
        tot = issue + stall
        frac = stall / tot if tot > 0 else 0.0
        lines.append(f"  {ev['name']:<10s} issue {issue:10.1f}us  "
                     f"stall {stall:10.1f}us  ({frac:5.1%} stalled)")
    return lines


def _chaos_report(evs: list[dict], rep: dict) -> list[str]:
    """Fault-layer roll-up: the ``fault.*`` counters plus grouped
    ``instant()`` fault events, so a chaos run's injected failures,
    retries, reroutes and recoveries read off one section."""
    lines = []
    counters = rep.get("counters", {}) if isinstance(rep, dict) else {}
    fc = {k: v for k, v in sorted(counters.items())
          if k.startswith("fault.")}
    for k, v in fc.items():
        n = v.get("count", v) if isinstance(v, dict) else v
        lines.append(f"  {k:<28s} {n:>10}")
    insts: dict[str, int] = {}
    for ev in evs:
        if ev.get("ph") in ("i", "I") and \
                str(ev.get("name", "")).startswith("fault."):
            insts[ev["name"]] = insts.get(ev["name"], 0) + 1
    if insts:
        lines.append("  instant events:")
        for name, cnt in sorted(insts.items()):
            lines.append(f"    {name:<26s} x{cnt}")
    return lines


def _ascii_heatmap(hm: dict, width: int = 2) -> list[str]:
    """Per-PE heat (sum of incident link bytes) as a character grid."""
    shape = hm.get("shape", [])
    if len(shape) != 2:
        return []
    rows, cols = shape
    heat = [[0.0] * cols for _ in range(rows)]
    for lk in hm.get("links", []):
        for coord in (lk["coord_a"], lk["coord_b"]):
            r, c = coord
            heat[r][c] += lk["bytes"] / 2.0
    peak = max((h for row in heat for h in row), default=0.0)
    ramp = " .:-=+*#%@"
    out = []
    for row in heat:
        line = ""
        for h in row:
            i = int(h / peak * (len(ramp) - 1)) if peak > 0 else 0
            line += ramp[i] * width
        out.append("  |" + line + "|")
    return out


def report(trace_path: pathlib.Path, metrics_path: pathlib.Path | None,
           top: int) -> None:
    doc = json.loads(trace_path.read_text())
    evs = [e for e in doc.get("traceEvents", []) if isinstance(e, dict)]
    rep = doc.get("repro", {})
    print(f"== tracereport: {trace_path} ==")
    print(f"{len(evs)} events, level {rep.get('level', '?')}, "
          f"{rep.get('events_dropped', 0)} dropped, "
          f"{rep.get('sink_errors', 0)} sink errors")

    rows = _top_spans(evs, top)
    if rows:
        print(f"\ntop {len(rows)} runtime spans by total time:")
        for name, tot, cnt in rows:
            print(f"  {name:<28s} {tot:12.1f}us  x{cnt}")

    stalls = _stall_report(evs)
    if stalls:
        print("\nquiet/fence stall attribution:")
        print("\n".join(stalls))

    chaos = _chaos_report(evs, rep)
    if chaos:
        print("\nchaos summary (fault layer, DESIGN.md §17):")
        print("\n".join(chaos))

    rl = rep.get("roofline")
    if isinstance(rl, dict) and rl.get("cells"):
        pk = rl.get("peaks", {})
        print(f"\nroofline summary (machine {rl.get('machine', '?')}, "
              f"peak {pk.get('flops', 0) / 1e9:.1f} GFLOP/s, "
              f"{pk.get('mem_Bps', 0) / 1e9:.1f} GB/s mem, "
              f"NoC {pk.get('link_GBs', 0):.2f} GB/s):")
        print(f"  {'cell':<26s} {'wall':>10s} {'compute':>10s} "
              f"{'memory':>10s} {'noc':>10s} {'bottleneck':>10s} "
              f"{'MFU':>7s}")
        for c in rl["cells"]:
            print(f"  {c['cell']:<26s} {c['wall_us']:>8.1f}us "
                  f"{c['compute_us']:>8.1f}us {c['memory_us']:>8.1f}us "
                  f"{c['noc_us']:>8.1f}us {c['bottleneck']:>10s} "
                  f"{min(c.get('mfu', 0.0), 9.999):>7.3f}")

    for hm in rep.get("heatmap", []):
        shape = "x".join(map(str, hm["shape"]))
        print(f"\nNoC heatmap ({shape} mesh, {hm['n_links']} links, "
              f"{hm['total_bytes'] / 1e6:.2f}MB total):")
        for lk in hm["links"][:top]:
            print(f"  link {lk['a']:>3d}<->{lk['b']:<3d} "
                  f"{lk['bytes'] / 1e3:10.1f}kB  "
                  f"{lk['coord_a']}-{lk['coord_b']}")
        grid = _ascii_heatmap(hm)
        if grid:
            print("  per-PE heat:")
            print("\n".join(grid))

    if metrics_path is not None:
        mdoc = json.loads(metrics_path.read_text())
        print(f"\n== metrics: {metrics_path} ==")
        print(f"{'metric':<28s} {'count':>8s} {'p50':>12s} {'p90':>12s} "
              f"{'p99':>12s}")
        for name, m in sorted(mdoc.get("metrics", {}).items()):
            if m.get("type") == "histogram" and m.get("count"):
                print(f"{name:<28s} {m['count']:>8d} "
                      + " ".join(f"{(m.get(p) or 0) * 1e3:>10.3f}ms"
                                 for p in ("p50", "p90", "p99")))
            elif m.get("type") == "counter" and m.get("value"):
                print(f"{name:<28s} {m['value']:>8.0f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="Chrome trace JSON from --trace-out")
    ap.add_argument("--metrics", default="",
                    help="metrics registry JSON from --metrics-out")
    ap.add_argument("--top", type=int, default=10,
                    help="rows per section")
    ap.add_argument("--check", action="store_true",
                    help="validate document schemas and exit non-zero on "
                         "violations (the CI artifact gate)")
    ap.add_argument("--diff", default="",
                    help="second trace to diff against: per-span/"
                         "per-stage wall deltas + hottest-link shifts "
                         "(repro_torch.tools.perfdiff)")
    args = ap.parse_args(argv)
    tpath = pathlib.Path(args.trace)
    mpath = pathlib.Path(args.metrics) if args.metrics else None

    if args.diff:
        from . import perfdiff
        rep = perfdiff.diff_traces(
            json.loads(pathlib.Path(args.diff).read_text()),
            json.loads(tpath.read_text()), top=args.top,
            baseline=args.diff, current=str(tpath))
        print(perfdiff.render(rep))
        return

    if args.check:
        errs = validate_trace(json.loads(tpath.read_text()))
        if mpath is not None:
            errs += [f"metrics: {e}" for e in
                     validate_metrics(json.loads(mpath.read_text()))]
        if errs:
            for e in errs:
                print(f"SCHEMA VIOLATION: {e}", file=sys.stderr)
            sys.exit(1)
        print(f"schema check OK: {tpath}"
              + (f" + {mpath}" if mpath else ""))

    report(tpath, mpath, args.top)


if __name__ == "__main__":
    main()
