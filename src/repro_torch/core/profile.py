"""Runtime profiler — the ``shmem_pcontrol`` analogue (port of
`repro/core/profile.py`, DESIGN.md §13).

  * :class:`Profiler` records one :class:`OpSample` per collective (kind,
    interned schedule id, team shape, payload bytes, resolved algorithm /
    chunk count / embedding, wall time, bytes moved, hottest-link load,
    model-predicted time) plus lightweight counters for RMA and raw
    ppermute traffic.  Attach it with ``ShmemContext(profile=...)`` (it
    propagates to the context's net and every
    :class:`~repro_torch.core.shmem.Ctx`).
  * ``pcontrol(level)`` follows OpenSHMEM ``shmem_pcontrol`` semantics:
    0 disables collection, 1 keeps aggregate counters, >=2 additionally
    keeps the per-op timeline.  When disabled (or when no profiler is
    attached — the default) the hot path pays ONE ``is None``/flag test:
    no device wait and no launch.
  * Wall times on the card include the device's work: an op opened with
    ``device=`` a CUDA device waits for that device as it opens and as it
    closes, so the sample (and every sink that reads it at commit, like
    ``Tuner.observe``) sees the time the launches took, not the time it
    took to queue them.  A CUDA device that cannot be waited on raises.
  * Samples recorded inside CUDA-graph capture or ``torch.compile``
    tracing (:func:`trace_clean` is False) are flagged ``traced=True``:
    they never wait on the device (a wait would break the capture), their
    wall times are staging times, the tracer renders them with their
    predicted duration, and the tuner's online refinement skips them.
    :func:`measure` is the steady-state timer the calibration sweep uses.
  * ``to_json()``/``dump(path)`` export the aggregate counters and the
    timeline in one machine-readable document (the reference's schema);
    ``add_sink(fn)`` streams every committed sample to observers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Callable

import torch

from .heap import tree_flatten


def trace_clean() -> bool:
    """True when called OUTSIDE CUDA-graph capture and ``torch.compile``
    tracing — wall times measured here are execution times; inside they
    are staging times."""
    if torch.compiler.is_compiling():
        return False
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return not torch.cuda.is_current_stream_capturing()
    return True


def wait_device(device) -> None:
    """Block the host until every launch queued on `device` has finished
    (nothing on the CPU, whose ops run synchronously)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def tensor_device(tree):
    """The device of the first tensor leaf of `tree` (None when it holds
    no tensor)."""
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


@dataclasses.dataclass
class OpSample:
    """One profiled operation — the per-op record the timeline exports.

    ``kind`` distinguishes timed collectives ("collective"), non-blocking
    RMA issues ("rma"), bare selection decisions recorded outside any
    timed region ("selection"), calibration measurements ("measure"),
    quiet/fence memory-ordering points ("sync" — wall time split into
    ``issue_s`` + ``stall_s``, DESIGN.md §16), and user spans
    ("span")."""

    collective: str
    nbytes: float = 0.0
    n_pes: int = 0
    team: str = ""                 # group shape, e.g. "n16", "team4of16"
    kind: str = "collective"
    t_start: float = 0.0           # seconds since the profiler's epoch
    wall_s: float = 0.0
    algorithm: str = ""
    chunks: int = 1
    embedding: str = ""            # "", "snake", or "perm:..."
    schedule: str = ""             # interned Schedule name (e.g. allreduce.ring)
    n_stages: int = 0
    bytes_moved: float = 0.0       # schedule total wire bytes
    max_link_load: float = 0.0     # hottest stage's hottest-link multiplicity
    predicted_s: float = float("nan")   # alpha-beta modeled time
    traced: bool = False           # recorded under capture/compile staging
    fingerprint: str = ""          # tuner topology key (tuner.fingerprint)
    issue_s: float = 0.0           # "sync" kind: time spent issuing
    stall_s: float = 0.0           # "sync" kind: time stalled on pending ops
    meta: dict | None = None       # free-form span annotations (trace args)
    stage_costs: list | None = None  # per-stage cost-model attribution:
    #                                  [{nbytes, hops, load, predicted_s}]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["predicted_s"] != d["predicted_s"]:     # NaN (unpredicted):
            d["predicted_s"] = None                  # json.dump would emit
        return d                                     # an invalid literal


def _emb_str(embedding) -> str:
    """Canonical string form of an embedding knob/order for sample and
    tuning-DB keys: "" identity/off, "snake"/"auto" pass through, an
    explicit order becomes "perm:i,j,..."."""
    if embedding is None:
        return ""
    if isinstance(embedding, str):
        return embedding
    return "perm:" + ",".join(str(int(p)) for p in embedding)


class Profiler:
    """pcontrol-style runtime profiler (levels: 0 off, 1 counters,
    >=2 counters + per-op timeline).  Thread-safe; the open-op stack is
    thread-local so concurrent contexts don't interleave notes."""

    #: consecutive failures after which a raising sink is dropped
    SINK_MAX_FAILURES = 3

    def __init__(self, level: int = 2, max_samples: int = 100_000):
        self.level = int(level)
        self.max_samples = max_samples
        self.samples: list[OpSample] = []
        self.dropped = 0
        self.sink_errors = 0
        self.sinks_dropped = 0
        self._counters: dict[str, dict[str, float]] = {}
        self._sinks: list[Callable[[OpSample], None]] = []
        self._sink_fails: dict[int, int] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._epoch = time.perf_counter()

    # -- control (shmem_pcontrol) -------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.level > 0

    def pcontrol(self, level: int) -> None:
        """OpenSHMEM ``shmem_pcontrol``: 0 disables collection, 1 enables
        the default (counters), >= 2 enables detailed collection (the
        per-op timeline).  Takes effect on the next recorded op."""
        self.level = int(level)

    def reset(self) -> None:
        with self._lock:
            self.samples = []
            self._counters = {}
            self.dropped = 0
            self._epoch = time.perf_counter()

    def add_sink(self, fn: Callable[[OpSample], None]) -> None:
        """Stream every committed sample to `fn` (e.g. ``Tuner.observe``
        for online refinement).  Sinks run synchronously at commit, after
        the sample is final.  A sink must never abort the instrumented
        op: exceptions are caught and counted (``sink_errors``), and a
        sink that fails ``SINK_MAX_FAILURES`` consecutive times is
        dropped (``sinks_dropped``)."""
        if fn not in self._sinks:
            self._sinks.append(fn)
            self._sink_fails[id(fn)] = 0

    # -- recording -----------------------------------------------------------
    def _open_stack(self) -> list[OpSample]:
        st = getattr(self._tls, "open", None)
        if st is None:
            st = []
            self._tls.open = st
        return st

    @contextlib.contextmanager
    def op(self, collective: str, nbytes: float = 0.0, n_pes: int = 0,
           team: str = "", kind: str = "collective", fingerprint: str = "",
           device=None):
        """Time a region as one op sample.  Selection notes emitted while
        the region is open (``note``) enrich this sample; nested ``op``
        regions record separately (innermost note wins).  With a CUDA
        `device`, the region waits for it as it opens and as it closes,
        so ``wall_s`` covers the device's work (never under capture)."""
        if not self.enabled:
            yield None
            return
        traced = not trace_clean()
        s = OpSample(collective=collective, nbytes=float(nbytes),
                     n_pes=int(n_pes), team=team or f"n{n_pes}", kind=kind,
                     traced=traced, fingerprint=fingerprint)
        wait = None if traced else device
        stack = self._open_stack()
        stack.append(s)
        wait_device(wait)
        t0 = time.perf_counter()
        s.t_start = t0 - self._epoch
        try:
            yield s
        finally:
            try:
                wait_device(wait)
            finally:
                s.wall_s = time.perf_counter() - t0
                stack.pop()
            self._commit(s)

    def note(self, algorithm: str | None = None, chunks: int | None = None,
             schedule=None, topo=None, link=None, embedding=None,
             collective: str | None = None, nbytes: float | None = None,
             n_pes: int | None = None) -> None:
        """Record the RESOLVED selection of the innermost open op (the
        executors call this once algorithm/chunks/embedding are known).
        The note only enriches an open op of the SAME collective (or one
        opened without a name): a selection made inside some other timed
        region must not relabel that region's sample, so it commits a
        bare "selection" sample instead."""
        if not self.enabled:
            return
        stack = self._open_stack()
        matches = bool(stack) and (
            collective is None or not stack[-1].collective
            or stack[-1].collective == collective)
        if matches:
            s = stack[-1]
        else:
            stack = []                  # commit as a standalone selection
            s = OpSample(collective=collective or "", kind="selection",
                         t_start=time.perf_counter() - self._epoch,
                         traced=not trace_clean())
        if algorithm is not None:
            s.algorithm = algorithm
        if chunks is not None:
            s.chunks = int(chunks)
        if embedding is not None:
            s.embedding = _emb_str(embedding)
        if collective is not None and not s.collective:
            s.collective = collective
        if nbytes is not None and not s.nbytes:
            s.nbytes = float(nbytes)
        if n_pes is not None and not s.n_pes:
            s.n_pes = int(n_pes)
            if not s.team:
                s.team = f"n{s.n_pes}"
        if schedule is not None:
            s.schedule = schedule.name
            s.n_stages = len(schedule.stages)
            s.bytes_moved = float(schedule.total_bytes())
            # the object references the tracer renders per-PE stage spans
            # and link heatmaps from (not exported by to_dict)
            s._sched, s._topo = schedule, topo
            try:
                s.max_link_load = max(
                    (st.pattern.max_link_load(topo)
                     for st in schedule.stages), default=0.0)
            except Exception:
                s.max_link_load = 0.0
            try:
                # per-stage attribution: the (bytes, hops, load)
                # descriptors eq. 1 prices, plus the per-stage modeled
                # time when a link model is known (DESIGN.md §18)
                s.stage_costs = []
                for st in schedule.stages:
                    nb, hops, load = st.cost(topo)
                    c = {"nbytes": float(nb), "hops": float(hops),
                         "load": float(load)}
                    if link is not None:
                        c["predicted_s"] = link.time(nb, hops, load)
                    s.stage_costs.append(c)
            except Exception:
                s.stage_costs = None
            if link is not None:
                s.predicted_s = schedule.pipelined_time(
                    max(s.chunks, 1), topo, link)
        if not stack:
            self._commit(s)

    def count(self, key: str, n: int = 1, nbytes: float = 0.0) -> None:
        """Bare aggregate counter (no timeline entry) — what the net's
        ppermute hook uses; near-zero cost, safe under capture."""
        if not self.enabled:
            return
        with self._lock:
            c = self._counters.setdefault(
                key, {"count": 0.0, "total_s": 0.0, "total_bytes": 0.0})
            c["count"] += n
            c["total_bytes"] += float(nbytes)

    def record_rma(self, op: str, nbytes: float, pattern=None,
                   n_pes: int = 0) -> None:
        """One non-blocking RMA issue (put_nbi/get_nbi) — counters always,
        a timeline entry at level >= 2.  No wall time: completion is
        pinned later by quiet()."""
        if not self.enabled:
            return
        self.count(f"rma.{op}", 1, nbytes)
        if self.level >= 2:
            s = OpSample(collective=op, kind="rma", nbytes=float(nbytes),
                         n_pes=n_pes,
                         t_start=time.perf_counter() - self._epoch,
                         traced=not trace_clean())
            if pattern is not None:
                s.n_stages = 1
                s.bytes_moved = float(nbytes) * max(len(pattern.pairs), 1)
            with self._lock:
                if len(self.samples) < self.max_samples:
                    self.samples.append(s)
                else:
                    self.dropped += 1

    def record_sync(self, op: str, n_ops: int, nbytes: float, *,
                    issue_s: float, stall_s: float = 0.0, n_pes: int = 0,
                    t_start: float | None = None) -> None:
        """One memory-ordering point (``quiet``/``fence``) with its wall
        time split into issue time (ordering and retiring the pending
        ops) and stall time (waiting until the pending ops actually land
        on the device) — DESIGN.md §16."""
        if not self.enabled:
            return
        if t_start is None:
            t_start = (time.perf_counter() - self._epoch
                       - issue_s - stall_s)
        s = OpSample(collective=op, kind="sync", nbytes=float(nbytes),
                     n_pes=int(n_pes), t_start=t_start,
                     wall_s=issue_s + stall_s, issue_s=float(issue_s),
                     stall_s=float(stall_s), traced=not trace_clean(),
                     meta={"n_ops": int(n_ops)})
        self._commit(s)

    def _commit(self, s: OpSample) -> None:
        if not self.enabled:    # pcontrol(0) raced the op: drop cleanly
            return
        key = f"{s.kind}.{s.collective}" + (
            f".{s.algorithm}" if s.algorithm else "")
        with self._lock:
            c = self._counters.setdefault(
                key, {"count": 0.0, "total_s": 0.0, "total_bytes": 0.0})
            c["count"] += 1
            c["total_s"] += s.wall_s
            c["total_bytes"] += s.nbytes
            if s.kind == "sync":
                c["issue_s"] = c.get("issue_s", 0.0) + s.issue_s
                c["stall_s"] = c.get("stall_s", 0.0) + s.stall_s
            if self.level >= 2:
                if len(self.samples) < self.max_samples:
                    self.samples.append(s)
                else:
                    self.dropped += 1
        for sink in list(self._sinks):
            try:
                sink(s)
                self._sink_fails[id(sink)] = 0
            except Exception:
                # a sink must not abort the instrumented op: count the
                # failure and drop the sink once it fails repeatedly
                self.sink_errors += 1
                fails = self._sink_fails.get(id(sink), 0) + 1
                self._sink_fails[id(sink)] = fails
                if fails >= self.SINK_MAX_FAILURES:
                    try:
                        self._sinks.remove(sink)
                    except ValueError:
                        pass
                    self.sinks_dropped += 1

    # -- export --------------------------------------------------------------
    def counters(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._counters.items()}

    def timeline(self) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in self.samples]

    def to_json(self) -> dict:
        return {
            "schema": 1,
            "level": self.level,
            "dropped": self.dropped,
            "sink_errors": self.sink_errors,
            "sinks_dropped": self.sinks_dropped,
            "counters": self.counters(),
            "timeline": self.timeline(),
        }

    def dump(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)


def measure(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            profile: Profiler | None = None, device=None,
            **sample_kw) -> float:
    """Steady-state wall time per call, seconds — the single copy of the
    calibration methodology (``Tuner.tune``, ``Tuner.refit_link`` and the
    card's smoke measure identically).  Runs `fn(*args)` once and waits,
    runs ``warmup - 1`` more calls (each waited for), then times `iters`
    calls ended by ONE device wait (none on the CPU).  `device` defaults
    to the device of the first tensor in `args`.  With `profile`,
    commits one "measure"-kind sample carrying `sample_kw`."""
    dev = device if device is not None else tensor_device(args)
    fn(*args)
    wait_device(dev)
    for _ in range(max(warmup - 1, 0)):
        fn(*args)
        wait_device(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    wait_device(dev)
    t = (time.perf_counter() - t0) / iters
    if profile is not None and profile.enabled:
        s = OpSample(collective=sample_kw.pop("collective", "measure"),
                     kind="measure", wall_s=t,
                     t_start=t0 - profile._epoch)
        emb = sample_kw.pop("embedding", None)
        if emb is not None:
            s.embedding = _emb_str(emb)
        for k, v in sample_kw.items():
            if hasattr(s, k):
                setattr(s, k, v)
        if not s.team:
            s.team = f"n{s.n_pes}"
        profile._commit(s)
    return t
