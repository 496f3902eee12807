"""Serving metrics: counters / gauges / histograms plus the engine's
request-lifecycle recorder (port of `repro/serve/metrics.py`, DESIGN.md
§16).  The JSON document is the reference's (schema 1): either package's
`tracereport` validates the other's.

`MetricsRegistry` is a minimal in-process metrics surface — enough to
answer "where did this request's latency go" without any external
collector:

  * `Counter`   — monotonic event counts (requests, tokens, steps).
  * `Gauge`     — last-observed values (queue depth, KV occupancy).
  * `Histogram` — log-spaced buckets over a fixed range plus a bounded
    raw-sample reservoir, so both bucket counts (cheap, exact export)
    and true percentiles (from the reservoir) are available.  TTFT and
    per-token latency are the headline users.

`ServeMetrics` binds a registry to the `ServeEngine` lifecycle:
enqueue -> admit (+prefill/first token) -> per-step decode -> evict,
with admission backpressure waits and PagePool occupancy/fragmentation
sampled every engine step.  `attach(profile)` lets `to_json()` fold in
the profiler's wire-byte counters and the tracer's NoC heatmap, so one
metrics document carries the full serving + network picture.

Everything here is pure host-side Python; nothing touches the device, so
the registry costs nothing on the device path and is safe from any
thread.
"""
from __future__ import annotations

import json
import math
import pathlib
import threading
import time


class Counter:
    """Monotonic float counter."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def to_json(self) -> dict:
        return {"type": "counter", "value": self.value, "help": self.help}


class Gauge:
    """Last-observed value (plus running min/max for the summary)."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.n_samples = 0

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.n_samples += 1

    def to_json(self) -> dict:
        return {"type": "gauge", "value": self.value,
                "min": self.min if self.n_samples else None,
                "max": self.max if self.n_samples else None,
                "n_samples": self.n_samples, "help": self.help}


class Histogram:
    """Log-spaced-bucket histogram with a bounded raw reservoir.

    Buckets span [lo, hi) in `n_buckets` equal log steps, with one
    underflow and one overflow bucket at the ends.  The first
    `reservoir` raw observations are kept verbatim so `percentile()` is
    exact for short runs (a serving smoke records hundreds of samples,
    not millions); beyond that, percentiles degrade gracefully to the
    retained prefix while bucket counts stay exact forever.
    """

    def __init__(self, name: str, help: str = "", lo: float = 1e-6,
                 hi: float = 100.0, n_buckets: int = 40,
                 reservoir: int = 8192):
        self.name, self.help = name, help
        self.lo, self.hi = float(lo), float(hi)
        self.n_buckets = int(n_buckets)
        self._log_lo = math.log(self.lo)
        self._log_step = (math.log(self.hi) - self._log_lo) / n_buckets
        self.buckets = [0] * (n_buckets + 2)     # [under, ..., over]
        self.count = 0
        self.sum = 0.0
        self._raw: list[float] = []
        self._reservoir = int(reservoir)

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self.n_buckets + 1
        return 1 + int((math.log(v) - self._log_lo) / self._log_step)

    def observe(self, v: float) -> None:
        v = float(v)
        self.buckets[self._bucket(v)] += 1
        self.count += 1
        self.sum += v
        if len(self._raw) < self._reservoir:
            self._raw.append(v)

    def bucket_edges(self) -> list[float]:
        return [math.exp(self._log_lo + i * self._log_step)
                for i in range(self.n_buckets + 1)]

    def percentile(self, q: float) -> float:
        """q in [0, 100], from the raw reservoir (nan when empty)."""
        if not self._raw:
            return math.nan
        xs = sorted(self._raw)
        k = min(len(xs) - 1, max(0, round(q / 100.0 * (len(xs) - 1))))
        return xs[k]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def to_json(self) -> dict:
        pct = {f"p{q}": self.percentile(q) for q in (50, 90, 99)}
        return {"type": "histogram", "count": self.count, "sum": self.sum,
                "mean": self.mean if self.count else None,
                **{k: (None if math.isnan(v) else v)
                   for k, v in pct.items()},
                "bucket_lo": self.lo, "bucket_hi": self.hi,
                "buckets": self.buckets, "help": self.help}


class MetricsRegistry:
    """Named metric store with JSON export (schema 1)."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get(name, Histogram, help, **kw)

    def _get(self, name, cls, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                                f"not {cls.__name__}")
            return m

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def __getitem__(self, name: str):
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def to_json(self) -> dict:
        return {"schema": 1,
                "metrics": {n: m.to_json()
                            for n, m in sorted(self._metrics.items())}}

    def dump(self, path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_json(), indent=1))


class ServeMetrics:
    """Request-lifecycle metrics for `ServeEngine` (DESIGN.md §16).

    The engine calls the `on_*` hooks at each lifecycle edge; every
    latency is measured host-side around the forced device sync (the
    sampled tokens' copy to the host), so the per-token histogram records
    the wall time a client sees.
    """

    def __init__(self, registry: MetricsRegistry | None = None):
        r = registry if registry is not None else MetricsRegistry()
        self.registry = r
        self._profile = None
        self._submit_t: dict[int, float] = {}
        self._admit_t: dict[int, float] = {}
        # counters
        self.requests_submitted = r.counter(
            "serve.requests_submitted", "requests entering the queue")
        self.requests_admitted = r.counter(
            "serve.requests_admitted", "requests admitted into slots")
        self.requests_completed = r.counter(
            "serve.requests_completed", "requests evicted with results")
        self.tokens_generated = r.counter(
            "serve.tokens_generated", "total generated tokens")
        self.prefill_runs = r.counter(
            "serve.prefill_runs", "paged prefill forward passes")
        self.decode_steps = r.counter(
            "serve.decode_steps", "batched decode steps executed")
        self.backpressure_waits = r.counter(
            "serve.backpressure_waits",
            "engine steps where the queue head could not get pages")
        self.pe_failures = r.counter(
            "serve.pe_failures", "PE failures detected during step()")
        self.requests_requeued = r.counter(
            "serve.requests_requeued",
            "live requests re-queued after a PE failure")
        self.engine_steps = r.counter(
            "serve.engine_steps", "evict/admit/decode iterations")
        # gauges
        self.queue_depth = r.gauge(
            "serve.queue_depth", "queued (unadmitted) requests")
        self.active_slots = r.gauge(
            "serve.active_slots", "slots holding live sequences")
        self.kv_pages_live = r.gauge(
            "serve.kv_pages_live", "PagePool live pages")
        self.kv_pages_free = r.gauge(
            "serve.kv_pages_free", "PagePool allocatable pages")
        self.kv_occupancy = r.gauge(
            "serve.kv_occupancy", "live / allocatable page fraction")
        self.kv_fragmentation = r.gauge(
            "serve.kv_fragmentation",
            "recycled fraction of the available pages")
        # histograms (seconds)
        self.ttft_s = r.histogram(
            "serve.ttft_s", "submit -> first token latency")
        self.per_token_s = r.histogram(
            "serve.per_token_s", "per-decode-step wall time per token")
        self.admission_wait_s = r.histogram(
            "serve.admission_wait_s", "submit -> admit queue wait")
        self.e2e_s = r.histogram(
            "serve.e2e_s", "submit -> eviction end-to-end latency")
        self.recovery_s = r.histogram(
            "serve.recovery_s", "PE-failure drain + re-queue wall time")

    # -- lifecycle hooks (ServeEngine calls these) ---------------------------
    def on_submit(self, rid: int) -> None:
        self.requests_submitted.inc()
        self._submit_t[rid] = time.perf_counter()

    def on_admit(self, rid: int) -> None:
        now = time.perf_counter()
        self.requests_admitted.inc()
        self._admit_t[rid] = now
        t0 = self._submit_t.get(rid)
        if t0 is not None:
            self.admission_wait_s.observe(now - t0)

    def on_first_token(self, rid: int) -> None:
        self.prefill_runs.inc()
        self.tokens_generated.inc()
        t0 = self._submit_t.get(rid)
        if t0 is not None:
            self.ttft_s.observe(time.perf_counter() - t0)

    def on_decode_step(self, n_active: int, wall_s: float) -> None:
        self.decode_steps.inc()
        self.tokens_generated.inc(n_active)
        self.per_token_s.observe(wall_s)

    def on_evict(self, rid: int) -> None:
        self.requests_completed.inc()
        t0 = self._submit_t.pop(rid, None)
        self._admit_t.pop(rid, None)
        if t0 is not None:
            self.e2e_s.observe(time.perf_counter() - t0)

    def on_backpressure(self) -> None:
        self.backpressure_waits.inc()

    def on_pe_failure(self, n_requeued: int,
                      recovery_s: float | None = None) -> None:
        """A PE failure drained the engine: `n_requeued` live requests
        went back to the queue head (DESIGN.md §17)."""
        self.pe_failures.inc()
        self.requests_requeued.inc(n_requeued)
        if recovery_s is not None:
            self.recovery_s.observe(recovery_s)

    def sample_engine(self, engine) -> None:
        """Per-step gauge sweep: scheduler queue + PagePool state."""
        self.engine_steps.inc()
        sched = engine.scheduler
        pool = engine.kv.pool
        self.queue_depth.set(len(sched.queue))
        self.active_slots.set(len(sched.active_slots()))
        self.kv_pages_live.set(pool.live_pages())
        self.kv_pages_free.set(pool.pages_available())
        self.kv_occupancy.set(pool.occupancy())
        self.kv_fragmentation.set(pool.fragmentation())

    # -- export --------------------------------------------------------------
    def attach(self, profile) -> None:
        """Fold a Profiler/Tracer's wire counters (and heatmap, when the
        profile is a Tracer) into this document's to_json()."""
        self._profile = profile

    def to_json(self) -> dict:
        doc = self.registry.to_json()
        p = self._profile
        if p is not None:
            wire = {k: dict(v) for k, v in p.counters().items()
                    if k.startswith(("rma.", "ppermute", "collective.",
                                     "sync.", "fault."))}
            doc["wire"] = wire
            heatmap = getattr(p, "heatmap", None)
            if callable(heatmap):
                doc["heatmap"] = heatmap()
        return doc

    def dump(self, path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_json(), indent=1))
