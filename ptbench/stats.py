"""The arithmetic of the end-to-end metrics: a tail over every sample of
the window and a rate over all of its work and all of its time."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0-100) of every value, by linear interpolation
    between closest ranks (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, t0: float, t1: float) -> float:
    """count over the window [t0, t1] in seconds."""
    return count / (t1 - t0)


def in_window(t: float, t0: float, t1: float) -> bool:
    """Whether an event at host time t falls inside the window (t0, t1]:
    the window opens at the end of one engine step and closes at the end
    of another, so an event stamped at an opening step's end is not in
    it and one at the closing step's end is."""
    return t0 < t <= t1

