"""Span-based distributed tracer — Chrome trace-event / Perfetto export
(port of `repro/core/trace.py`, DESIGN.md §16).

:class:`Tracer` subclasses :class:`~repro_torch.core.profile.Profiler`
(so every ``profile=`` thread-through — ``ShmemContext``, ``Ctx``,
``build_train_step``, ``ServeEngine`` — accepts one unchanged, and the
disabled hot path stays the one flag test ``pcontrol`` already pays) and
additionally renders:

  * **per-PE tracks** (pid 0, one tid per PE): every collective whose
    executor noted its :class:`~repro_torch.core.pattern.Schedule` gets
    one sub-span per stage on every participating PE's track, placed
    inside the op's measured interval (device-inclusive on the card) and
    apportioned by the stage's share of the schedule's payload.
    Collectives recorded inside CUDA-graph capture or ``torch.compile``
    tracing (``traced=True``) have no execution interval of their own,
    so their stage spans stretch over the modeled time (``predicted_s``)
    instead, flagged ``traced`` in the event args.
  * **cross-PE flow links** (Chrome ``s``/``f`` events): each stage's
    ``(src, dst)`` pairs become flow arrows, capped at ``flows_per_op``
    per op.
  * a **host runtime track** (pid 1): op/span/sync samples as complete
    events, ``quiet`` stall time as a child span separate from issue
    time, RMA issues and selection decisions as instants.
  * **async request tracks**: ``begin_async``/``instant_async``/
    ``end_async`` emit Chrome async events (the serving engine's
    enqueue -> admit -> first token -> evict lifecycle, keyed by
    request id).
  * a **NoC link heatmap**: every noted schedule with a topology
    accumulates ``stage.nbytes x link multiplicity`` per physical link,
    exported by :meth:`Tracer.heatmap` and embedded in the document.

Levels extend ``shmem_pcontrol``: 0 off, 1 counters, 2 counters +
timeline + host-track events, >= 3 additionally per-PE stage spans and
flow links (the "full trace").  ``dump_chrome(path)`` writes a JSON
document loadable at ``ui.perfetto.dev`` / ``chrome://tracing`` (and by
the reference's ``tracereport``); ``python -m
repro_torch.tools.tracereport`` summarizes one in text.
"""
from __future__ import annotations

import contextlib
import json
import time

from .profile import OpSample, Profiler

PID_PE = 0          # the PE-grid process: tid k = PE k
PID_HOST = 1        # the host runtime process: tid 0 = ops track

LEVEL_FULL = 3      # pcontrol level that adds stage spans + flow links


class Tracer(Profiler):
    """A :class:`Profiler` that additionally renders Chrome trace events.

    Drop-in wherever a profiler is accepted (``profile=``): the base
    class records counters/timeline exactly as before and the overridden
    ``_commit`` turns each committed sample into trace events.  All
    direct-event APIs (``span``/``instant``/``begin_async``/...) cost one
    level test when collection is off."""

    def __init__(self, level: int = LEVEL_FULL, max_events: int = 500_000,
                 flows_per_op: int = 64, **kw):
        super().__init__(level=level, **kw)
        self.max_events = int(max_events)
        self.flows_per_op = int(flows_per_op)
        self._events: list[dict] = []
        self.events_dropped = 0
        self._flow_seq = 0
        self._n_pes_seen = 1
        # per-topology accumulated link bytes: {topo: {(u, v): bytes}}
        self._link_bytes: dict = {}
        # extra JSON sections merged into the document's ``repro``
        # metadata (e.g. the roofline summary benchmarks/roofline.py
        # embeds for ``tracereport``); reserved keys are ignored
        self.sections: dict = {}

    # -- low-level event plumbing --------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def _event(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(ev)
            else:
                self.events_dropped += 1

    def reset(self) -> None:
        super().reset()
        with self._lock:
            self._events = []
            self.events_dropped = 0
            self._flow_seq = 0
            self._link_bytes = {}

    # -- direct span / instant / async APIs ----------------------------------
    @contextlib.contextmanager
    def span(self, name: str, nbytes: float = 0.0, n_pes: int = 0, *,
             device=None, **meta):
        """An arbitrary nested host-track span, timed like any op (it IS
        an op sample of kind "span", so it lands in the timeline and the
        chrome track both; a CUDA `device` makes it device-inclusive).
        `meta` becomes the event's args."""
        with self.op(name, nbytes=nbytes, n_pes=n_pes, kind="span",
                     device=device) as s:
            if s is not None and meta:
                s.meta = dict(meta)
            yield s

    def instant(self, name: str, pe: int | None = None, **args) -> None:
        """A host-track (or PE-track, with `pe`) instant event."""
        if self.level < 2:
            return
        ev = {"name": name, "ph": "i", "ts": self._now_us(), "s": "t",
              "pid": PID_HOST if pe is None else PID_PE,
              "tid": 0 if pe is None else int(pe)}
        if args:
            ev["args"] = args
        self._event(ev)

    def _async(self, ph: str, cat: str, aid, name: str, args: dict) -> None:
        if self.level < 2:
            return
        ev = {"name": name, "ph": ph, "cat": cat, "id": str(aid),
              "ts": self._now_us(), "pid": PID_HOST, "tid": 0}
        if args:
            ev["args"] = args
        self._event(ev)

    def begin_async(self, cat: str, aid, name: str, **args) -> None:
        """Open an async track span (e.g. a request lifecycle).  The
        matching :meth:`end_async` must use the same (cat, aid, name)."""
        self._async("b", cat, aid, name, args)

    def instant_async(self, cat: str, aid, name: str, **args) -> None:
        """A point event inside an open async span (admit, first token)."""
        self._async("n", cat, aid, name, args)

    def end_async(self, cat: str, aid, name: str, **args) -> None:
        self._async("e", cat, aid, name, args)

    # -- sample -> events -----------------------------------------------------
    def _commit(self, s: OpSample) -> None:
        super()._commit(s)
        if self.level >= 2 and self.enabled:
            self._render(s)

    def record_rma(self, op: str, nbytes: float, pattern=None,
                   n_pes: int = 0) -> None:
        super().record_rma(op, nbytes, pattern, n_pes=n_pes)
        if self.level >= 2:
            ev = {"name": op, "ph": "i", "ts": self._now_us(), "s": "t",
                  "pid": PID_HOST, "tid": 0, "cat": "rma",
                  "args": {"nbytes": float(nbytes)}}
            self._event(ev)

    def _args_of(self, s: OpSample) -> dict:
        args: dict = {"kind": s.kind}
        for k in ("algorithm", "team", "schedule", "embedding"):
            v = getattr(s, k)
            if v:
                args[k] = v
        if s.nbytes:
            args["nbytes"] = s.nbytes
        if s.chunks > 1:
            args["chunks"] = s.chunks
        if s.n_stages:
            args["n_stages"] = s.n_stages
            args["bytes_moved"] = s.bytes_moved
            args["max_link_load"] = s.max_link_load
        if s.predicted_s == s.predicted_s and s.predicted_s != 0.0:
            args["predicted_us"] = s.predicted_s * 1e6
        if s.traced:
            args["traced"] = True
        if s.kind == "sync":
            args["issue_us"] = s.issue_s * 1e6
            args["stall_us"] = s.stall_s * 1e6
        if s.meta:
            args.update(s.meta)
        return args

    def _render(self, s: OpSample) -> None:
        ts = s.t_start * 1e6
        dur = max(s.wall_s, 0.0) * 1e6
        name = s.collective or s.kind
        if s.algorithm and s.kind == "collective":
            name = f"{name}[{s.algorithm}]"
        if s.kind == "selection":
            self._event({"name": name, "ph": "i", "ts": ts, "s": "t",
                         "pid": PID_HOST, "tid": 0, "cat": "selection",
                         "args": self._args_of(s)})
        else:
            self._event({"name": name, "ph": "X", "ts": ts, "dur": dur,
                         "pid": PID_HOST, "tid": 0, "cat": s.kind,
                         "args": self._args_of(s)})
            if s.kind == "sync" and s.stall_s > 0.0:
                # the stall child span: time quiet spent WAITING on the
                # pending-op queue, visibly separate from issue time
                self._event({"name": f"{s.collective}.stall", "ph": "X",
                             "ts": ts + s.issue_s * 1e6,
                             "dur": s.stall_s * 1e6, "pid": PID_HOST,
                             "tid": 0, "cat": "stall"})
        sched = getattr(s, "_sched", None)
        if sched is None:
            return
        topo = getattr(s, "_topo", None)
        if topo is not None:
            self._account_links(sched, topo)
        if self.level >= LEVEL_FULL:
            if s.traced or dur <= 0.0:
                # a staged (traced) collective has no execution interval;
                # stretch its stage spans over the modeled time instead
                pred = s.predicted_s
                dur = pred * 1e6 if pred == pred and pred > 0.0 \
                    else 1.0 * max(len(sched.stages), 1)
            self._render_stages(s, sched, ts, dur)

    def _account_links(self, sched, topo) -> None:
        with self._lock:
            lb = self._link_bytes.setdefault(topo, {})
            for st in sched.stages:
                for link, mult in st.pattern.link_loads(topo).items():
                    lb[link] = lb.get(link, 0.0) + st.nbytes * mult

    def _render_stages(self, s: OpSample, sched, ts: float,
                       dur: float) -> None:
        stages = sched.stages
        if not stages:
            return
        weights = [st.nbytes + 1.0 for st in stages]
        total = sum(weights)
        cap = self.flows_per_op
        t = ts
        seen_pe = self._n_pes_seen
        costs = s.stage_costs or []
        for k, st in enumerate(stages):
            d = dur * weights[k] / total
            pes = sorted({p for pair in st.pattern.pairs for p in pair})
            if pes:
                seen_pe = max(seen_pe, pes[-1] + 1)
            args = {"nbytes": st.nbytes, "stage": k}
            if k < len(costs) and isinstance(costs[k], dict):
                # stamp the per-stage cost-model attribution onto the
                # span so a viewer (or tracereport --diff) can compare
                # wall vs modeled stage time directly
                args["hops"] = costs[k].get("hops", 0.0)
                args["link_load"] = costs[k].get("load", 0.0)
                pred = costs[k].get("predicted_s")
                if pred is not None:
                    args["predicted_us"] = pred * 1e6
            if s.traced:
                args["traced"] = True
            for pe in pes:
                self._event({"name": f"{sched.name}.s{k}", "ph": "X",
                             "ts": t, "dur": d, "pid": PID_PE, "tid": pe,
                             "cat": "stage", "args": args})
            for src, dst in st.pattern.pairs:
                if cap <= 0 or src == dst:
                    continue
                cap -= 1
                with self._lock:
                    fid = self._flow_seq
                    self._flow_seq += 1
                self._event({"name": "noc", "ph": "s", "id": fid,
                             "ts": t + 0.6 * d, "pid": PID_PE, "tid": src,
                             "cat": "flow"})
                self._event({"name": "noc", "ph": "f", "bp": "e",
                             "id": fid, "ts": t + 0.9 * d, "pid": PID_PE,
                             "tid": dst, "cat": "flow"})
            t += d
        self._n_pes_seen = seen_pe

    # -- NoC heatmap export ---------------------------------------------------
    def heatmap(self) -> list[dict]:
        """Accumulated per-physical-link wire bytes, one entry per
        topology seen, links sorted hottest-first — the NoC heatmap
        (built on ``CommPattern.link_loads``; rendered as an ASCII grid
        by ``repro_torch.tools.tracereport``)."""
        with self._lock:
            items = [(topo, dict(lb)) for topo, lb in
                     self._link_bytes.items()]
        out = []
        for topo, lb in items:
            links = [{"a": int(u), "b": int(v), "bytes": float(b),
                      "coord_a": list(topo.coords(u)),
                      "coord_b": list(topo.coords(v))}
                     for (u, v), b in sorted(lb.items(),
                                             key=lambda kv: -kv[1])]
            out.append({"shape": list(topo.shape),
                        "n_links": len(links),
                        "max_bytes": links[0]["bytes"] if links else 0.0,
                        "total_bytes": float(sum(lk["bytes"]
                                                 for lk in links)),
                        "links": links})
        return out

    # -- chrome export --------------------------------------------------------
    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON-object document: ``traceEvents``
        plus a ``repro`` metadata section (counters, heatmap, schema) the
        viewers ignore and ``tracereport`` reads."""
        meta = [
            {"name": "process_name", "ph": "M", "pid": PID_PE,
             "args": {"name": "PE mesh"}},
            {"name": "process_name", "ph": "M", "pid": PID_HOST,
             "args": {"name": "runtime"}},
            {"name": "thread_name", "ph": "M", "pid": PID_HOST, "tid": 0,
             "args": {"name": "ops"}},
        ]
        for pe in range(self._n_pes_seen):
            meta.append({"name": "thread_name", "ph": "M", "pid": PID_PE,
                         "tid": pe, "args": {"name": f"PE {pe}"}})
        with self._lock:
            events = list(self._events)
        rep = {
            "schema": 1,
            "level": self.level,
            "events_dropped": self.events_dropped,
            "sink_errors": self.sink_errors,
            "counters": self.counters(),
            "heatmap": self.heatmap(),
        }
        for k, v in self.sections.items():
            rep.setdefault(k, v)        # user sections never shadow core
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "repro": rep,
        }

    def dump_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
