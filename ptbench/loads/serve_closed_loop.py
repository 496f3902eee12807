"""Closed-loop serving through the port's paged continuous-batching
engine, `repro_torch.serve.engine.ServeEngine`, in process.

`concurrency` clients each hold one request in flight.  When a request
has its last token at the end of an engine step, its client submits the
next request of the stream at once, so the engine sees it in the next
step.  The loop starts in its steady state (`traffic.Stream.first`),
and the warm-up runs the same traffic until `warmup_completions`
requests have finished (every shape the traffic uses, prefill at the
bucket and the decode step, has run by then); the window then opens,
the card idle between two engine steps, and closes at the end of the
first step `seconds` later.  Requests submitted inside the window
are stepped to their first token after it closes, and no more are
submitted.  A token's time is the host clock at the end of the step that
delivered it (every step ends in a host read of the sampled tokens)."""
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from ..devtrace import DeviceTrace
from ..traffic import Stream
from ..window import Rec, Step, Window

MAX_TAIL_STEPS = 10_000
ALLOC_COUNTS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def _alloc_counts(device) -> dict:
    """The caching allocator's retries and device allocations and frees
    so far (for the log: each is a cudaMalloc or cudaFree inside the
    timed path)."""
    if device.type != "cuda":
        return dict.fromkeys(ALLOC_COUNTS, 0)
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in ALLOC_COUNTS}


def run(job) -> Window:
    from repro_torch.core.trace import Tracer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.metrics import ServeMetrics

    mix, device, traced = job.mix, job.device, job.trace
    metrics = ServeMetrics() if traced else None
    tracer = Tracer() if traced else None
    dtrace = DeviceTrace() if traced and device.type == "cuda" else None
    eng = ServeEngine(job.cfg, params=job.ref.program_tree(job.weights),
                      device=device, metrics=metrics, profile=tracer,
                      **mix["engine"])
    stream = Stream(mix, job.seed, job.arch["vocab_size"])
    recs: dict[int, Rec] = {}
    steps: list[Step] = []
    submitting = [True]

    def submit(t, req=None):
        prompt, n = req or next(stream)
        rid = eng.submit(prompt, n)
        recs[rid] = Rec(rid, t, prompt, n)

    def phase(name):
        return torch.profiler.record_function(name) if dtrace \
            else contextlib.nullcontext()

    def step():
        t_start = time.perf_counter()
        with phase("ptbench.engine_step"):
            info = eng.step()
        t = time.perf_counter()
        with phase("ptbench.client"):
            done = 0
            for st in eng.scheduler.slots:
                if st is None:
                    continue
                rec = recs[st.rid]
                rec.times += [t] * (len(st.out) - len(rec.times))
                if st.done and rec.t_done is None:
                    rec.t_done, rec.tokens = t, np.asarray(st.out, np.int32)
                    done += 1
                    if submitting[0]:
                        submit(t)
        steps.append(Step(t_start, t, list(info["admitted"]),
                          int(info["decoded"])))
        return t, done

    t = time.perf_counter()
    for req in stream.first(int(mix["concurrency"])):
        submit(t, req)
    completions = 0
    while completions < int(mix["warmup_completions"]):
        t, done = step()
        completions += done
    if dtrace is not None:
        dtrace.prepare()
    setup_s = job.setup_clock()
    print(f"ptbench: window opens after {len(steps)} warm-up steps, "
          f"set-up {setup_s:.3f} s", file=sys.stderr, flush=True)

    alloc0 = _alloc_counts(device)
    t0 = t = time.perf_counter()
    n_rec0 = len(recs)
    dec0 = (metrics.per_token_s.sum, metrics.per_token_s.count) \
        if metrics else None
    span0 = len(tracer.samples) if tracer else 0
    traced_first = len(steps)
    traced_last = None
    if dtrace is not None:
        dtrace.start()
    while t - t0 < job.seconds:
        t, _ = step()
        if dtrace is not None and traced_last is None and \
                t - t0 >= float(mix.get("trace_seconds", 5)) and \
                any(s.admitted for s in steps[traced_first:]):
            dtrace.stop()
            traced_last = len(steps)
    t1 = t
    alloc = {k: v - alloc0[k] for k, v in _alloc_counts(device).items()}
    print(f"ptbench: window closed after {len(steps)} steps, "
          f"{t1 - t0:.3f} s; allocator in the window {alloc}",
          file=sys.stderr, flush=True)
    if dtrace is not None and traced_last is None:
        dtrace.stop()
        traced_last = len(steps)
    decode_walls = None
    if metrics is not None:
        decode_walls = (metrics.per_token_s.sum - dec0[0],
                        metrics.per_token_s.count - dec0[1])
    prefill_walls = None
    if tracer is not None:
        prefill_walls = [s.wall_s for s in tracer.samples[span0:]
                         if s.collective == "serve.prefill"]

    # the window's requests stepped to their first token; none submitted
    submitting[0] = False
    in_window = [r for r in list(recs.values())[n_rec0:]]
    for _ in range(MAX_TAIL_STEPS):
        if all(r.times for r in in_window):
            break
        step()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()
    trace = dtrace.summary() if dtrace is not None else None
    if trace is not None:
        print(f"ptbench: device trace {trace['timings']}", file=sys.stderr)
    return Window(t0=t0, t1=t1, setup_s=setup_s, recs=list(recs.values()),
                  steps=steps, attempted=len(in_window),
                  failed=sum(1 for r in in_window if not r.times),
                  memory_peak_bytes=peak, decode_walls=decode_walls,
                  prefill_walls=prefill_walls, trace=trace,
                  traced_steps=(traced_first, traced_last)
                  if dtrace is not None else None)
