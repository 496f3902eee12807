"""What a load hands the metric readers: the window's host times, every
request's record, the engine steps, and in a traced run the program's
spans and counters and the device trace."""
from __future__ import annotations

import dataclasses

import numpy as np

from .stats import in_window


@dataclasses.dataclass
class Rec:
    """One request as its client saw it: submit time, prompt, output
    length, the host time each token reached it, and its tokens once
    finished."""
    rid: int
    t_submit: float
    prompt: np.ndarray
    max_new: int
    times: list = dataclasses.field(default_factory=list)
    tokens: np.ndarray | None = None
    t_done: float | None = None


@dataclasses.dataclass
class Step:
    t_start: float
    t_end: float
    admitted: list          # rids prefilled in this step
    decoded: int            # slots decoded in this step


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    setup_s: float
    recs: list
    steps: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    decode_walls: tuple | None = None     # (sum s, count) in the window
    prefill_walls: list | None = None     # serve.prefill span walls, s
    trace: dict | None = None             # devtrace.summary
    traced_steps: tuple | None = None     # (first, last + 1) into steps

    def finished(self) -> list:
        """Requests that finished inside the window."""
        return [r for r in self.recs
                if r.t_done is not None and self.t0 < r.t_done <= self.t1]

    def token_gaps(self) -> list:
        """Every inter-token gap, in seconds, of every request, that ends
        inside the window: from the step end that delivered one token to
        the step end that delivered the next (a gap that holds a prefill
        counts; two tokens of one step are a gap of 0)."""
        return [b - a for r in self.recs for a, b in zip(r.times, r.times[1:])
                if in_window(b, self.t0, self.t1)]

    def first_token_waits(self) -> list:
        """For every request submitted inside the window, the seconds from
        its submission to the end of the step that delivered its first
        token (stepped to after the window where it came late)."""
        return [r.times[0] - r.t_submit for r in self.recs
                if in_window(r.t_submit, self.t0, self.t1) and r.times]
