"""The program's ranges on the device trace's clock.

While the profiler records, the port's tracer opens a `record_function`
range around each phase of the serving engine and each part of the paged
model (`repro_torch.core.trace.region`: `serve.step`, `serve.decode`,
`model.layers`, `layer.attn.kv`, ...).  `attribute` reads the raw kineto
events of a stopped profiler and puts down to those ranges:

  * each device operation's busy time, through the runtime call that
    launched it (kineto's correlation id), to the innermost program
    range open on the host when that call ran;
  * every idle stretch of the device, between two merged device
    operations and from the recording's start to the first and from the
    last to its end, to the innermost program range open on the host at
    the stretch's midpoint, or to `(outside the engine)`.

A range is keyed by its path, the names of the ranges that hold it
(`serve.step/serve.decode/model.layers/layer.attn.kv`).  Device
operations and the harness's own annotations are told apart as
`devtrace.py` tells them, so the busy seconds add up to its `busy_s`,
and busy plus idle seconds to the recording's wall on the profiler's
clock (its `ProfilerStep` range).  The engine's ranges are taken to come
from one host thread."""
from __future__ import annotations

import bisect
import collections

from .devtrace import ANNOTATIONS

OUTSIDE = "(outside the engine)"
# the model's ranges: idle under them is the host launching the model's
# kernels slower than the card runs them; idle anywhere else is the
# engine's host work (scheduling, batch assembly, sampling, emitting) or
# the harness's
MODEL = ("model.", "layer.")
UNLAUNCHED = "(no launch seen)"
# the CUDA API calls that launch device work (`cudaLaunchKernel`,
# `cuLaunchKernelEx`, `cudaMemcpyAsync`, ...) carry the correlation id of
# what they launch
LAUNCHES = ("cu",)
STEP = "ProfilerStep"


def events(prof):
    """(device ops, program ranges, launch times, recording) of a stopped
    profiler: device ops (start us, end us, correlation id); program
    ranges (start us, end us, name); {correlation id: start us} of the
    runtime calls; (start us, end us) of the profiler's step range, or
    None."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, ranges, launches, wall = [], [], {}, None
    for e in prof.profiler.kineto_results.events():
        name, start, end = e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3
        note = e.is_user_annotation() or name.startswith(ANNOTATIONS)
        if e.device_type() == cuda:
            if not note:
                dev.append((start, end, e.correlation_id()))
        elif note:
            if name.startswith(STEP):
                wall = (start, end)
            elif not name.startswith(ANNOTATIONS):
                ranges.append((start, end, name))
        elif name.startswith(LAUNCHES) and e.correlation_id():
            launches[e.correlation_id()] = start
    return dev, ranges, launches, wall


class Timeline:
    """The innermost open range's path at any host time, from properly
    nested ranges (start us, end us, name)."""

    def __init__(self, ranges):
        self.times, self.paths = [], []
        self.counts = collections.Counter()
        stack: list = []                    # (end, path)

        def close_until(t):
            while stack and stack[-1][0] <= t:
                end, _ = stack.pop()
                self._mark(end, stack[-1][1] if stack else None)

        for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
            close_until(s)
            path = f"{stack[-1][1]}/{name}" if stack else name
            stack.append((min(e, stack[-1][0]) if stack else e, path))
            self.counts[path] += 1
            self._mark(s, path)
        close_until(float("inf"))

    def _mark(self, t, path):
        if self.times and self.times[-1] == t:
            self.paths[-1] = path
        else:
            self.times.append(t)
            self.paths.append(path)

    def at(self, t) -> str:
        i = bisect.bisect_right(self.times, t) - 1
        path = self.paths[i] if i >= 0 else None
        return OUTSIDE if path is None else path


def attribute(dev, ranges, launches, wall=None) -> dict:
    """{"wall_s", "busy_s", "idle_s", "ranges": {path: {"busy_s",
    "idle_s", "count"}}} of one recording (the arguments as `events`
    returns them; `wall` defaults to the first op's start and the last
    op's end, and ops are cut to it).  Busy time is the union of the
    device ops, each instant given to the op that started first among
    those covering it."""
    if wall is None:
        wall = (min(s for s, _, _ in dev), max(e for _, e, _ in dev)) \
            if dev else (0.0, 0.0)
    t0, t1 = wall
    line = Timeline(ranges)
    out: dict = collections.defaultdict(
        lambda: {"busy_s": 0.0, "idle_s": 0.0, "count": 0})
    for path, n in line.counts.items():
        out[path]["count"] = n
    busy = []                               # merged [start, end]
    for s, e, corr in sorted((max(s, t0), min(e, t1), c)
                             for s, e, c in dev if e > t0 and s < t1):
        lo = max(s, busy[-1][1]) if busy else s
        if e > lo:
            t = launches.get(corr)
            out[UNLAUNCHED if t is None else line.at(t)]["busy_s"] += \
                (e - lo) * 1e-6
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    edges = [t0] + [x for b in busy for x in b] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            out[line.at((a + b) / 2)]["idle_s"] += (b - a) * 1e-6
    return {"wall_s": (t1 - t0) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "idle_s": sum(v["idle_s"] for v in out.values()),
            "ranges": dict(out)}


def leaf(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def idle_split(ranges: dict) -> tuple[float, float]:
    """(idle seconds under the model's ranges, idle seconds anywhere
    else) of `attribute`'s ranges."""
    model = sum(v["idle_s"] for p, v in ranges.items()
                if leaf(p).startswith(MODEL))
    return model, sum(v["idle_s"] for v in ranges.values()) - model


def summary(prof) -> dict:
    """`attribute` over the events of a stopped profiler."""
    return attribute(*events(prof))


def program_counts(profile) -> dict:
    """The engine's padding tallies (`Profiler.tallies`) so far, for a
    load to take the window's deltas of; empty for a program that keeps
    none."""
    tallies = getattr(profile, "tallies", None)
    return dict(tallies()) if tallies is not None else {}
