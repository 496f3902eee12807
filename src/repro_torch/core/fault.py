"""Typed failures of the runtime (DESIGN.md §17) — the part of
`repro/core/fault.py` that `core/shmem.py` needs.

The fault injector that raises them (`FaultInjector`, `FaultPlan`) is not
ported yet: with nothing attached, no transfer fails and `quiet()`/
`fence()` see no straggler delay.  `fault_event` records on an attached
profiler or tracer.
"""
from __future__ import annotations

from .pattern import CommPattern


class FaultError(RuntimeError):
    """Base of all fault errors.  Carries the offending resource, the
    compiled pattern that tripped it, and the plan step."""

    def __init__(self, msg: str, *, pe: int | None = None,
                 link: tuple[int, int] | None = None,
                 pattern: CommPattern | None = None,
                 step: int | None = None, op: str | None = None,
                 attempts: int = 0):
        super().__init__(msg)
        self.pe = pe
        self.link = link
        self.pattern = pattern
        self.step = step
        self.op = op
        self.attempts = attempts


class PEFailure(FaultError):
    """A transfer named a dead PE as source or destination."""


class LinkFailure(FaultError):
    """A transfer's route (and its alternate) crosses a dropped link."""


class DeadlineExceeded(FaultError):
    """quiet()/fence() could not complete within its deadline — the
    straggler-detection surface (a slow PE's DMA never landing)."""


def fault_event(profile, name: str, n: int = 1, **args) -> None:
    """Record a fault-layer event on an attached profiler: a counter, and
    an instant event where the profiler keeps a timeline (a
    :class:`~repro_torch.core.trace.Tracer`).  Nothing when no profiler is
    attached or it is disabled."""
    if profile is None or not profile.enabled:
        return
    profile.count(name, n)
    inst = getattr(profile, "instant", None)
    if inst is not None:
        inst(name, **args)
