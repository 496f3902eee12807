"""The device trace of a traced run: torch.profiler (CPU and CUDA
activity) over a span of whole engine steps.

`summary` reads from it the device's busy time (the union of every
kernel, copy and set on the card), the time of each kernel by name, and
the idle gaps between device operations, each named by the innermost
host operation running at its midpoint (or the harness's own
`record_function` phase, which the device side of the trace also
shows and which is no device work).  The idle share is 1 - busy / wall, as
`repro_torch/tools/profile_serve.py` computes it, with the busy time a
union rather than a sum."""
from __future__ import annotations

import collections
import heapq
import time

import torch

GAPS_NAMED = 500
# record_function ranges, the harness's phases and the profiler's step
ANNOTATIONS = ("ptbench.", "ProfilerStep")


class DeviceTrace:
    """The profiler is prepared during set-up (`prepare`: its first start
    takes seconds) and records from `start` to `stop`, both called at the
    end of an engine step."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.timings = {}

    def prepare(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule
        t = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1))
        self.prof.__enter__()
        self.timings["prepare_s"] = time.perf_counter() - t

    def start(self) -> None:
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.prof.step()
        self.t0 = time.perf_counter()
        self.timings["start_s"] = self.t0 - t

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.timings["stop_s"] = time.perf_counter() - self.t1

    def summary(self, top: int = 10) -> dict:
        t = time.perf_counter()
        dev, host = [], []
        for is_dev, start, end, name, note in _events(self.prof):
            if note or name.startswith(ANNOTATIONS):
                if not is_dev:
                    host.append((start, end, name))
            else:
                (dev if is_dev else host).append((start, end, name))
        self.prof = None
        out = summarize(dev, host, self.t1 - self.t0, top)
        self.timings["read_s"] = time.perf_counter() - t
        self.timings["events"] = len(dev) + len(host)
        out["timings"] = self.timings
        return out


def _events(prof):
    """(on the device, start us, end us, name, is an annotation) of every
    event of a stopped profiler, from its raw kineto results (building
    torch's FunctionEvent tree of some 10^5 events takes a minute)."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        yield (e.device_type() == cuda, e.start_ns() * 1e-3,
               e.end_ns() * 1e-3, e.name(), e.is_user_annotation())


def summarize(dev, host, window_s: float, top: int = 10) -> dict:
    """dev, host: (start_us, end_us, name) of device and host events.
    Returns busy_s, window_s, kernel seconds by name, and the device ops
    and idle gaps of the breakdown (at most `top` each)."""
    by_name = collections.Counter()
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-6
    spans = sorted((s, e) for s, e, _ in dev)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:GAPS_NAMED]
    named = collections.Counter()
    for (length, a, b), name in zip(gaps, _name_gaps(gaps, host)):
        named[name] += length * 1e-6
    return {"busy_s": busy_s, "window_s": window_s,
            "kernel_s": dict(by_name),
            "device_ops": [[n[:160], s] for n, s in by_name.most_common(top)],
            "idle_gaps": [[n[:160], s] for n, s in named.most_common(top)]}


def _name_gaps(gaps, host):
    """The innermost host event running at each gap's midpoint."""
    mids = sorted(range(len(gaps)), key=lambda i: (gaps[i][1] + gaps[i][2]))
    events = sorted(host)
    names = ["host (no profiled op)"] * len(gaps)
    active: list = []
    j = 0
    for i in mids:
        mid = (gaps[i][1] + gaps[i][2]) / 2
        while j < len(events) and events[j][0] <= mid:
            s, e, n = events[j]
            heapq.heappush(active, (e, s, n))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        if active:
            names[i] = min(active, key=lambda x: x[0] - x[1])[2]
    return names
