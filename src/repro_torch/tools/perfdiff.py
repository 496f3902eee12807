"""Regression attribution: explain WHY a benchmark row moved, in
cost-model terms (port of `repro/tools/perfdiff.py`, DESIGN.md §18).

``check_regression.py`` can say a pinned grid point regressed >25%;
this tool says which term of the alpha-beta/congestion model moved it.
Given two ``BENCH_*.json`` documents (benchmarks/run.py ``--json``) it
decomposes every over-threshold row delta into:

  * **pick** — the recorded ``picked`` field changed (a different
    algorithm/chunk-count/embedding was selected);
  * **alpha / beta** — refit ``T = alpha + beta*L`` per size-swept row
    family in each document (the same :func:`repro_torch.core.abmodel.fit`
    the calibration sweep uses) and split the delta into the latency
    and bandwidth contributions at the row's payload size;
  * **contention** — the measured congestion factor (the
    ``contention_gamma`` row) shifted between runs;
  * **unexplained** — none of the model terms covers the delta (a new
    code path, machine noise, a changed fingerprint...).

Given two *trace* documents (``Tracer.dump_chrome``) it diffs per-span
and per-stage wall totals and the hottest NoC links instead
(``tracereport --diff`` delegates here).  ``check_regression.py`` runs
the bench-document flavor automatically on a gate failure and ships the
report as a CI artifact.

  PYTHONPATH=src python -m repro_torch.tools.perfdiff BENCH_9.json \\
      BENCH_10.json --json perfdiff_report.json
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import re
import sys

_SIZE_RE = re.compile(r"_(\d+)B")
_GAMMA_RE = re.compile(r"gamma=([\d.eE+-]+)")


def load(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def doc_kind(doc: dict) -> str:
    if "traceEvents" in doc:
        return "trace"
    if "rows" in doc:
        return "bench"
    raise ValueError("document is neither a BENCH_*.json (rows) nor a "
                     "Chrome trace (traceEvents)")


# ---------------------------------------------------------------------------
# bench-document diff
# ---------------------------------------------------------------------------

def _rows_by_key(doc: dict) -> dict[tuple[str, str], dict]:
    return {(r["bench"], r["name"]): r for r in doc.get("rows", [])}


def _family(name: str) -> str | None:
    """Row-family key: the name with its size suffix made a placeholder
    (``allreduce_rd_65536B`` -> ``allreduce_rd_{S}B``) — rows differing
    only in payload size fit one alpha-beta line."""
    if not _SIZE_RE.search(name):
        return None
    return _SIZE_RE.sub("_{S}B", name)


def _family_fits(doc: dict) -> dict[tuple[str, str], object]:
    """(bench, family) -> ABFit over that family's (size, measured)
    points; families without two distinct sizes are skipped (the fit
    would be singular)."""
    from ..core import abmodel
    groups: dict[tuple[str, str], list[tuple[int, float]]] = {}
    for r in doc.get("rows", []):
        fam = _family(r["name"])
        size = r.get("size_bytes")
        us = r.get("measured_us")
        if fam is None or size is None or us is None:
            continue
        if not math.isfinite(float(us)) or float(us) <= 0.0:
            continue
        groups.setdefault((r["bench"], fam), []).append(
            (int(size), float(us) * 1e-6))
    fits = {}
    for key, pts in groups.items():
        if len({s for s, _ in pts}) < 2:
            continue
        try:
            fits[key] = abmodel.fit([s for s, _ in pts],
                                    [t for _, t in pts])
        except Exception:
            pass
    return fits


def _gamma(doc: dict) -> float | None:
    """The measured congestion factor from the ``contention_gamma``
    row's derived string (measured_us is 0 there by design)."""
    for r in doc.get("rows", []):
        if r["name"] == "contention_gamma":
            m = _GAMMA_RE.search(str(r.get("derived", "")))
            if m:
                return float(m.group(1))
    return None


def diff_bench(base_doc: dict, cur_doc: dict, *, threshold: float = 1.25,
               min_us: float = 20.0,
               baseline: str = "baseline", current: str = "current") -> dict:
    """Attribution report for every shared row whose measured time
    regressed beyond ``threshold`` (base >= ``min_us``)."""
    base = _rows_by_key(base_doc)
    cur = _rows_by_key(cur_doc)
    fits_b = _family_fits(base_doc)
    fits_c = _family_fits(cur_doc)
    g_b, g_c = _gamma(base_doc), _gamma(cur_doc)
    gamma_moved = (g_b is not None and g_c is not None
                   and abs(g_c - g_b) > 0.05)

    m_b = base_doc.get("machine")
    m_c = cur_doc.get("machine")
    regressions = []
    compared = 0
    for key in sorted(set(base) & set(cur)):
        rb, rc = base[key], cur[key]
        b_us, c_us = float(rb["measured_us"]), float(rc["measured_us"])
        if not (math.isfinite(b_us) and math.isfinite(c_us)) \
                or b_us < min_us:
            continue
        compared += 1
        ratio = c_us / b_us
        if ratio <= threshold:
            continue
        entry = {"bench": key[0], "name": key[1], "base_us": b_us,
                 "cur_us": c_us, "ratio": ratio,
                 "delta_us": c_us - b_us, "terms": {}}
        # term 1: a changed algorithm/chunks/embedding pick
        pick_b, pick_c = rb.get("picked"), rc.get("picked")
        if pick_b != pick_c and (pick_b or pick_c):
            entry["terms"]["pick"] = {"base": pick_b, "cur": pick_c}
        # term 2: alpha/beta shift of the row's size family
        fam = _family(key[1])
        fkey = (key[0], fam) if fam else None
        size = rc.get("size_bytes") or rb.get("size_bytes")
        if fkey and fkey in fits_b and fkey in fits_c and size:
            fb, fc = fits_b[fkey], fits_c[fkey]
            entry["family"] = fam
            entry["terms"]["alpha_us"] = (fc.alpha - fb.alpha) * 1e6
            entry["terms"]["beta_us"] = \
                (fc.beta - fb.beta) * float(size) * 1e6
        # term 3: the measured congestion factor moved
        if gamma_moved:
            entry["terms"]["gamma"] = {"base": g_b, "cur": g_c}
        entry["attribution"], entry["detail"] = _classify(entry)
        regressions.append(entry)
    regressions.sort(key=lambda e: -e["ratio"])
    return {
        "kind": "bench",
        "baseline": baseline,
        "current": current,
        "threshold": threshold,
        "machine_base": m_b,
        "machine_cur": m_c,
        "machine_match": (None if m_b is None or m_c is None
                          else m_b == m_c),
        "gamma_base": g_b,
        "gamma_cur": g_c,
        "n_rows_compared": compared,
        "regressions": regressions,
    }


def _classify(entry: dict) -> tuple[str, str]:
    """Dominant-term classification of one regressed row."""
    t = entry["terms"]
    delta = entry["delta_us"]
    if "pick" in t:
        p = t["pick"]
        return "pick", (f"selection changed {p['base']!r} -> "
                        f"{p['cur']!r}: a different algorithm/chunks/"
                        f"embedding executed, not a slower link")
    a = t.get("alpha_us")
    b = t.get("beta_us")
    if a is not None and b is not None:
        dom, dom_us = ("alpha", a) if abs(a) >= abs(b) else ("beta", b)
        if abs(dom_us) >= 0.5 * abs(delta) and dom_us * delta > 0:
            if dom == "alpha":
                return "alpha", (f"family latency intercept moved "
                                 f"{a:+.1f}us (beta term {b:+.1f}us): "
                                 f"per-op overhead, not bandwidth")
            return "beta", (f"family bandwidth term moved {b:+.1f}us at "
                            f"this size (alpha term {a:+.1f}us): "
                            f"per-byte cost, not per-op overhead")
    if "gamma" in t:
        g = t["gamma"]
        return "contention", (f"measured congestion factor moved "
                              f"{g['base']:.2f} -> {g['cur']:.2f}: "
                              f"link-sharing serialization changed")
    return "unexplained", ("no model term covers the delta — suspect "
                           "machine noise, a changed fingerprint, or a "
                           "new code path")


# ---------------------------------------------------------------------------
# trace diff
# ---------------------------------------------------------------------------

def _span_totals(doc: dict, *, cat: str | None = None,
                 pid: int | None = None) -> dict[str, float]:
    agg: dict[str, float] = {}
    for ev in doc.get("traceEvents", []):
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        if pid is not None and ev.get("pid") != pid:
            continue
        if cat is not None and ev.get("cat") != cat:
            continue
        agg[ev["name"]] = agg.get(ev["name"], 0.0) \
            + float(ev.get("dur", 0.0))
    return agg


def _hot_links(doc: dict, top: int) -> list[dict]:
    hms = doc.get("repro", {}).get("heatmap", [])
    if not hms:
        return []
    return [{"a": lk["a"], "b": lk["b"], "bytes": lk["bytes"]}
            for lk in hms[0].get("links", [])[:top]]


def diff_traces(base_doc: dict, cur_doc: dict, *, top: int = 10,
                baseline: str = "baseline",
                current: str = "current") -> dict:
    """Per-span / per-stage wall deltas and hottest-link shifts between
    two tracer timelines."""
    def deltas(b: dict[str, float], c: dict[str, float]) -> list[dict]:
        out = [{"name": n, "base_us": b.get(n, 0.0),
                "cur_us": c.get(n, 0.0),
                "delta_us": c.get(n, 0.0) - b.get(n, 0.0)}
               for n in sorted(set(b) | set(c))]
        out.sort(key=lambda d: -abs(d["delta_us"]))
        return out[:top]

    spans = deltas(_span_totals(base_doc, pid=1),
                   _span_totals(cur_doc, pid=1))
    stages = deltas(_span_totals(base_doc, cat="stage"),
                    _span_totals(cur_doc, cat="stage"))
    hl_b = {(lk["a"], lk["b"]): lk["bytes"]
            for lk in _hot_links(base_doc, top)}
    hl_c = {(lk["a"], lk["b"]): lk["bytes"]
            for lk in _hot_links(cur_doc, top)}
    moves = [{"link": f"{a}<->{b}", "base_bytes": hl_b.get((a, b), 0.0),
              "cur_bytes": hl_c.get((a, b), 0.0)}
             for a, b in sorted(set(hl_b) | set(hl_c))]
    moves.sort(key=lambda m: -abs(m["cur_bytes"] - m["base_bytes"]))
    return {"kind": "trace", "baseline": baseline, "current": current,
            "spans": spans, "stages": stages, "hot_links": moves[:top]}


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def render(rep: dict) -> str:
    lines = [f"== perfdiff: {rep['current']} vs {rep['baseline']} =="]
    if rep["kind"] == "bench":
        if rep.get("machine_match") is False:
            lines.append("NOTE: documents come from DIFFERENT machines "
                         "— wall-time deltas partly reflect hardware")
        if rep.get("gamma_base") is not None \
                and rep.get("gamma_cur") is not None:
            lines.append(f"congestion gamma: {rep['gamma_base']:.2f} -> "
                         f"{rep['gamma_cur']:.2f}")
        regs = rep["regressions"]
        lines.append(f"{rep['n_rows_compared']} rows compared, "
                     f"{len(regs)} regressed beyond "
                     f"x{rep['threshold']:.2f}")
        for e in regs:
            lines.append(f"\n{e['bench']}/{e['name']}: "
                         f"{e['base_us']:.1f}us -> {e['cur_us']:.1f}us "
                         f"(x{e['ratio']:.2f})")
            lines.append(f"  attribution: {e['attribution'].upper()} — "
                         f"{e['detail']}")
            t = e["terms"]
            if "alpha_us" in t:
                lines.append(f"  family fit {e.get('family')}: "
                             f"alpha {t['alpha_us']:+.2f}us  "
                             f"beta*L {t['beta_us']:+.2f}us "
                             f"of {e['delta_us']:+.2f}us")
    else:
        for title, key, unit in (("runtime spans", "spans", "us"),
                                 ("stage spans", "stages", "us")):
            rows = rep.get(key, [])
            if not rows:
                continue
            lines.append(f"\ntop {title} by |delta|:")
            for d in rows:
                lines.append(f"  {d['name']:<28s} "
                             f"{d['base_us']:>10.1f}{unit} -> "
                             f"{d['cur_us']:>10.1f}{unit}  "
                             f"({d['delta_us']:+.1f}{unit})")
        if rep.get("hot_links"):
            lines.append("\nhottest-link shifts:")
            for m in rep["hot_links"]:
                lines.append(f"  {m['link']:<8s} "
                             f"{m['base_bytes']/1e3:>10.1f}kB -> "
                             f"{m['cur_bytes']/1e3:>10.1f}kB")
    return "\n".join(lines)


def diff(base_path, cur_path, *, threshold: float = 1.25,
         min_us: float = 20.0, top: int = 10) -> dict:
    """Auto-detecting entry point: bench-vs-bench or trace-vs-trace."""
    base_doc, cur_doc = load(base_path), load(cur_path)
    kb, kc = doc_kind(base_doc), doc_kind(cur_doc)
    if kb != kc:
        raise ValueError(f"cannot diff a {kb} document against a {kc} "
                         f"document")
    if kb == "bench":
        return diff_bench(base_doc, cur_doc, threshold=threshold,
                          min_us=min_us, baseline=str(base_path),
                          current=str(cur_path))
    return diff_traces(base_doc, cur_doc, top=top,
                       baseline=str(base_path), current=str(cur_path))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("baseline", help="BENCH_*.json or Chrome trace")
    ap.add_argument("current", help="same kind as baseline")
    ap.add_argument("--threshold", type=float, default=1.25,
                    help="report rows regressed beyond this ratio")
    ap.add_argument("--min-us", type=float, default=20.0,
                    help="skip rows whose baseline is below this")
    ap.add_argument("--top", type=int, default=10,
                    help="rows per trace-diff section")
    ap.add_argument("--json", default="",
                    help="also write the report as JSON (CI artifact)")
    args = ap.parse_args(argv)
    rep = diff(args.baseline, args.current, threshold=args.threshold,
               min_us=args.min_us, top=args.top)
    print(render(rep))
    if args.json:
        out = pathlib.Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rep, indent=1))
        print(f"[perfdiff] wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
