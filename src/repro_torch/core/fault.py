"""Deterministic fault injection + typed failures (DESIGN.md §17); port
of `repro/core/fault.py`.

Production scale means PEs and NoC links disappear mid-run.  OpenSHMEM
1.3 has NO fault-tolerance semantics — a dead core simply hangs its
peers at the next barrier — so this layer is deliberately beyond-spec:
faults surface as *typed Python errors* the runtime can catch and
recover from, never as silent hangs.

Three pieces:

  * :class:`FaultPlan` — a declarative, step-keyed schedule of fault
    events (dead PEs, dropped links, slow stragglers, and their heals).
    Purely host data, so a chaos run is exactly reproducible.
  * :class:`FaultInjector` — the active half, attached to a NetOps
    backend (``net.fault``).  Every ``ppermute`` consults it BEFORE it
    launches anything: patterns are static host objects, so the check
    is pure host code that costs one ``is None`` test when no injector
    is attached, works identically under SIM and NoC-SIM, and a faulted
    pattern moves no byte on the card.
  * :class:`PEFailure` / :class:`LinkFailure` / :class:`DeadlineExceeded`
    — typed errors carrying the offending PE/link, the compiled
    pattern, and the fault-plan step, so recovery code (and test
    assertions) see *what* failed, not just *that* something did.

Routing semantics: a transfer whose dimension-ordered XY route crosses a
dropped link first tries the alternate YX route
(:meth:`~repro_torch.core.topology.MeshTopology.route_alt`); only when
both are severed does :class:`LinkFailure` surface — at which point the
pending-op engine's retry/backoff (``Ctx`` in ``core/shmem.py``) takes
over, and a ``heal_after`` budget on the drop makes transient faults
deterministically recoverable after a known number of attempts.
"""
from __future__ import annotations

import dataclasses

from .pattern import CommPattern


# ---------------------------------------------------------------------------
# typed failures
# ---------------------------------------------------------------------------

class FaultError(RuntimeError):
    """Base of all injected-fault errors.  Carries the offending
    resource, the compiled pattern that tripped it, and the plan step."""

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


def _canon(a: int, b: int) -> tuple[int, int]:
    return (a, b) if a <= b else (b, a)


# ---------------------------------------------------------------------------
# the declarative plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault edge.  kind: "pe" | "link" | "straggler" with
    heal counterparts "heal_pe" | "heal_link" | "heal_straggler"."""

    step: int
    kind: str
    target: tuple
    delay_s: float = 0.0
    heal_after: int | None = None


class FaultPlan:
    """A deterministic schedule of faults, keyed by train/engine step.

    Builder methods return ``self`` so plans chain::

        plan = (FaultPlan().kill_pe(5, pe=9)
                           .drop_link(3, 0, 1, heal_after=2)
                           .slow_pe(2, pe=7, delay_s=0.05))

    The plan is pure data; :class:`FaultInjector` interprets it.  A
    ``heal_after=k`` on a dropped link makes the drop TRANSIENT: the
    k-th failed attempt heals it, so retry-with-backoff succeeds on a
    known attempt — the deterministic analogue of a flaky link."""

    def __init__(self):
        self.events: list[FaultEvent] = []

    def kill_pe(self, step: int, pe: int) -> "FaultPlan":
        self.events.append(FaultEvent(int(step), "pe", (int(pe),)))
        return self

    def heal_pe(self, step: int, pe: int) -> "FaultPlan":
        self.events.append(FaultEvent(int(step), "heal_pe", (int(pe),)))
        return self

    def drop_link(self, step: int, a: int, b: int,
                  heal_after: int | None = None) -> "FaultPlan":
        self.events.append(FaultEvent(
            int(step), "link", _canon(int(a), int(b)),
            heal_after=heal_after))
        return self

    def heal_link(self, step: int, a: int, b: int) -> "FaultPlan":
        self.events.append(FaultEvent(
            int(step), "heal_link", _canon(int(a), int(b))))
        return self

    def slow_pe(self, step: int, pe: int, delay_s: float) -> "FaultPlan":
        self.events.append(FaultEvent(
            int(step), "straggler", (int(pe),), delay_s=float(delay_s)))
        return self

    def heal_straggler(self, step: int, pe: int) -> "FaultPlan":
        self.events.append(FaultEvent(
            int(step), "heal_straggler", (int(pe),)))
        return self

    def state_at(self, step: int) -> tuple[frozenset, dict, dict]:
        """Cumulative fault state once every event with
        ``event.step <= step`` has applied: ``(dead_pes,
        {link: heal_after}, {pe: delay_s})``."""
        dead: set[int] = set()
        dropped: dict[tuple[int, int], int | None] = {}
        slow: dict[int, float] = {}
        for ev in sorted(self.events, key=lambda e: e.step):
            if ev.step > step:
                break
            if ev.kind == "pe":
                dead.add(ev.target[0])
            elif ev.kind == "heal_pe":
                dead.discard(ev.target[0])
            elif ev.kind == "link":
                dropped[ev.target] = ev.heal_after
            elif ev.kind == "heal_link":
                dropped.pop(ev.target, None)
            elif ev.kind == "straggler":
                slow[ev.target[0]] = ev.delay_s
            elif ev.kind == "heal_straggler":
                slow.pop(ev.target[0], None)
            else:
                raise ValueError(f"unknown fault kind {ev.kind!r}")
        return frozenset(dead), dropped, slow

    def __repr__(self) -> str:
        return f"FaultPlan({len(self.events)} events)"


# ---------------------------------------------------------------------------
# the injector (attached as net.fault)
# ---------------------------------------------------------------------------

def fault_event(profile, name: str, n: int = 1, **args) -> None:
    """Record a fault-layer event on an attached Profiler/Tracer: always
    a counter; additionally an ``instant()`` trace event when the
    profile is a Tracer (level 3) — what `tracereport` summarizes for
    chaos runs (DESIGN.md §17)."""
    if profile is None or not profile.enabled:
        return
    profile.count(name, n)
    inst = getattr(profile, "instant", None)
    if inst is not None:
        inst(name, **args)


class FaultInjector:
    """Interprets a :class:`FaultPlan` against live traffic.

    Attach with ``ShmemContext(fault=plan)`` (or ``net.fault =
    FaultInjector(plan, topo)`` directly); drive the clock with
    :meth:`set_step` from the train/engine loop.  ``check()`` is called
    by every backend ``ppermute`` — dead-PE and dropped-link faults
    raise typed errors at ISSUE time (the NoC would never accept the
    packet); straggler delays accumulate in :attr:`pending_delay_s` and
    surface at the COMPLETION point, ``Ctx.quiet`` (a slow PE's DMA
    takes longer to land, not longer to enqueue)."""

    def __init__(self, plan: FaultPlan, topo=None, profile=None):
        self.plan = plan
        self.topo = topo
        self.profile = profile
        self.step = 0
        self.pending_delay_s = 0.0
        self.stats: dict[str, int] = {}
        self._healed: set[tuple[int, int]] = set()
        self._link_attempts: dict[tuple[int, int], int] = {}
        self._refresh()

    # -- clock ---------------------------------------------------------------
    def set_step(self, step: int) -> None:
        self.step = int(step)
        self._refresh()

    def _refresh(self) -> None:
        dead, dropped, slow = self.plan.state_at(self.step)
        self.dead = dead
        self.dropped = {lk: ha for lk, ha in dropped.items()
                        if lk not in self._healed}
        self.slow = slow

    def _bump(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n

    # -- introspection --------------------------------------------------------
    @property
    def dead_pes(self) -> tuple[int, ...]:
        return tuple(sorted(self.dead))

    def consume_delay(self) -> float:
        """Drain the straggler delay accumulated since the last call —
        ``Ctx._enqueue`` attaches it to the issuing Future."""
        d, self.pending_delay_s = self.pending_delay_s, 0.0
        return d

    # -- the per-ppermute check ----------------------------------------------
    def _blocked(self, route, dropped) -> tuple[int, int] | None:
        for u, v in route:
            lk = _canon(u, v)
            if lk in dropped:
                return lk
        return None

    def check(self, p: CommPattern, net=None) -> None:
        """Raise PEFailure/LinkFailure when the pattern touches a dead
        PE or an unroutable dropped link; accumulate straggler delay."""
        if self.dead:
            for s, d in p.pairs:
                bad = s if s in self.dead else (d if d in self.dead
                                                else None)
                if bad is not None:
                    self._bump("fault.pe_hits")
                    fault_event(self.profile, "fault.pe_failure",
                                pe=bad, step=self.step)
                    raise PEFailure(
                        f"PE {bad} is dead (fault plan step {self.step}); "
                        f"pattern touches it with pair ({s}, {d})",
                        pe=bad, pattern=p, step=self.step)
        if self.dropped and self.topo is not None:
            for s, d in p.pairs:
                if s == d:
                    continue
                lk = self._blocked(self.topo.route(s, d), self.dropped)
                if lk is None:
                    continue
                alt = self.topo.route_alt(s, d)
                if self._blocked(alt, self.dropped) is None:
                    # the YX route avoids every dropped link: the
                    # adaptive-routing path — traffic flows, one counter
                    self._bump("fault.reroutes")
                    fault_event(self.profile, "fault.reroute",
                                link=list(lk), src=s, dst=d,
                                step=self.step)
                    continue
                tries = self._link_attempts.get(lk, 0) + 1
                self._link_attempts[lk] = tries
                heal = self.dropped[lk]
                if heal is not None and tries >= heal:
                    # transient drop: this failed attempt heals it —
                    # the NEXT attempt (a retry) goes through
                    self._healed.add(lk)
                    self._refresh()
                self._bump("fault.link_hits")
                fault_event(self.profile, "fault.link_failure",
                            link=list(lk), src=s, dst=d, step=self.step,
                            attempt=tries)
                raise LinkFailure(
                    f"link {lk} is down (fault plan step {self.step}, "
                    f"attempt {tries}) and the alternate YX route is "
                    f"also severed for pair ({s}, {d})",
                    link=lk, pattern=p, step=self.step, attempts=tries)
        if self.slow:
            delay = 0.0
            worst = None
            for s, d in p.pairs:
                for pe in (s, d):
                    t = self.slow.get(pe, 0.0)
                    if t > delay:
                        delay, worst = t, pe
            if delay > 0.0:
                self.pending_delay_s = max(self.pending_delay_s, delay)
                self._bump("fault.straggler_hits")
                fault_event(self.profile, "fault.straggler",
                            pe=worst, delay_s=delay, step=self.step)


def as_injector(fault, topo=None, profile=None) -> FaultInjector | None:
    """Normalize the ``fault=`` knob: a FaultPlan wraps into a fresh
    injector, an injector passes through (its topo/profile filled in
    when unset), None stays None."""
    if fault is None:
        return None
    if isinstance(fault, FaultPlan):
        return FaultInjector(fault, topo=topo, profile=profile)
    if isinstance(fault, FaultInjector):
        if fault.topo is None:
            fault.topo = topo
        if fault.profile is None:
            fault.profile = profile
        return fault
    raise TypeError(f"fault= expects FaultPlan | FaultInjector | None, "
                    f"got {type(fault).__name__}")


__all__ = [
    "FaultError", "PEFailure", "LinkFailure", "DeadlineExceeded",
    "FaultEvent", "FaultPlan", "FaultInjector", "as_injector",
    "fault_event",
]
