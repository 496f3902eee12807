"""ARL-OpenSHMEM-for-Epiphany API surface, bound to a NetOps backend (port
of `repro/core/shmem.py` on the SIM backend).

The OpenSHMEM 1.3 routine families the paper implements:

  setup/query     shmem_init / my_pe / n_pes / ptr      -> ShmemContext
  RMA             put / get (+ _nbi, quiet, fence)       §3.3-3.4
  atomics         fetch_add / add / swap / testset       §3.5
  collectives     barrier_all / barrier / broadcast /
                  collect / fcollect / reduce(to_all) /
                  alltoall                                §3.6
  locks           set_lock / test_lock / clear_lock       §3.7
  teams/contexts  team_world / team_split_strided /
                  team_split_2d / ctx_create              1.4+ (DESIGN §11)

Semantics notes (DESIGN.md §6, §10): gets are owner-pushed (the paper's
IPI-get is the *only* get on this substrate); atomics are deterministic
PE-ordered.  Non-blocking RMA runs on a pending-op engine (the e-DMA
descriptor queue analogue): `put_nbi`/`get_nbi` enqueue `Future`s carrying
their compiled pattern and payload size; `quiet` COMPLETES pending ops in
issue order and returns their values; `fence` orders pending ops per
destination PE WITHOUT completing them.

On the card an nbi op is issued on the CURRENT CUDA stream, like every
other op of the runtime: the stream runs launches in issue order, so an
op is complete before anything issued after it reads its value, and two
same-destination puts land in issue order (what `fence` promises) by
construction.  `quiet` therefore needs no device wait of its own; a host
that reads a value (``.cpu()``, ``.item()``) waits for it there.  With a
profiler attached and enabled, `quiet` does wait for the device, so that
its sync sample splits issue time from the stall on the pending ops
(DESIGN.md §16).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from . import collectives as coll
from . import fault as fault_mod
from . import team as team_mod
from . import tuner as tuner_mod
from .fault import DeadlineExceeded, LinkFailure
from .heap import tree_flatten
from .netops import NetOps, NocSimNetOps, SimNetOps, SpmdNetOps, rank_net
from .pattern import CommPattern, PatternLike, as_pattern
from .profile import Profiler, trace_clean, wait_device
from .topology import MeshTopology

_NULL_CM = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff policy for failed non-blocking RMA (DESIGN.md §17).

    A :class:`~repro_torch.core.fault.LinkFailure` at issue time is
    retried up to `max_retries` times with exponential backoff; a
    :class:`~repro_torch.core.fault.PEFailure` is NEVER retried.
    `deadline_s` is the default quiet()/fence() deadline when the caller
    passes none."""

    max_retries: int = 3
    backoff_s: float = 1e-3
    backoff_mult: float = 2.0
    deadline_s: float | None = None


@dataclasses.dataclass(eq=False)    # a handle: identity, not value, equality
class Future:
    """Pending-op record of a non-blocking RMA (put_nbi/get_nbi) — one
    entry of the context's DMA descriptor queue (DESIGN.md §10).

    `quiet()` completes it, `fence()` orders it against later
    same-destination ops without completing it.  Reading .value before
    quiet() forfeits the completion guarantee — exactly like reading a
    DMA target buffer before shmem_quiet on the Epiphany.

    pattern : the compiled pattern that executes (for a get, the
              owner->requester push of the IPI-get);
    op      : "put" | "get";
    nbytes  : per-PE payload bytes the op moves (cost accounting);
    seq     : issue order within the owning context (monotonic);
    delay_s : straggler delay charged at quiet() (set by the fault
              injector at issue time)."""

    value: Any
    pattern: CommPattern | None = None
    op: str = "put"
    nbytes: float = 0.0
    seq: int = -1
    delay_s: float = 0.0
    _done: bool = False

    @property
    def done(self) -> bool:
        """True once quiet() has pinned this op's completion."""
        return self._done

    def target_pes(self) -> tuple[int, ...]:
        """Destination PEs the op writes to — what fence() orders by."""
        if self.pattern is None:
            return ()
        return tuple(int(i) for i in np.nonzero(self.pattern.dst_mask)[0])


class Ctx:
    """An OpenSHMEM 1.4 communication context (``shmem_ctx_create``): a
    PRIVATE pending-op queue over the owning :class:`ShmemContext`'s
    substrate (DESIGN.md §11).

    Non-blocking RMA issued on one context is invisible to every other:
    ``quiet()``/``fence()`` here drain/order ONLY this context's queue.
    An optional `team` makes the context team-scoped: RMA patterns are
    given in TEAM coordinates and lifted to the world pattern that
    executes (``Team.lift``), like ``shmem_team_create_ctx``."""

    def __init__(self, shmem: "ShmemContext", team=None):
        self.shmem = shmem
        self.team = team
        self._pending: list[Future] = []
        self._op_seq = 0

    @property
    def n_pes(self) -> int:
        return self.shmem.n_pes

    def compile(self, pattern: PatternLike) -> CommPattern:
        """Compile a pattern for this context — TEAM coordinates when the
        context is team-scoped (lifted to world), world otherwise."""
        if self.team is not None:
            return self.team.lift(pattern)
        return self.shmem.compile(pattern)

    def _owner_push(self, pattern: PatternLike) -> CommPattern:
        if self.team is None:
            return self.shmem._owner_push(pattern)
        if isinstance(pattern, CommPattern):
            return self.team.lift(pattern.inverse)
        return self.compile([(o, r) for r, o in pattern])

    # -- the pending-op engine (the e-DMA descriptor queue; DESIGN.md §10) ---
    def _enqueue(self, value, pattern: CommPattern, op: str, payload
                 ) -> Future:
        leaves, _ = tree_flatten(payload)
        nbytes = float(sum(l.numel() * l.element_size() for l in leaves))
        nbytes /= self.shmem.net.rows       # leading PE axis is not payload
        # Straggler delay charged by the fault injector at issue time
        # rides on the Future and is FELT at quiet() — a slow PE's DMA
        # takes longer to land, not longer to enqueue (DESIGN.md §17).
        inj = self.shmem.net.fault
        delay = inj.consume_delay() if inj is not None else 0.0
        f = Future(value, pattern=pattern, op=op, nbytes=nbytes,
                   seq=self._op_seq, delay_s=delay)
        self._op_seq += 1
        self._pending.append(f)
        prof = self.shmem.profile
        if prof is not None and prof.enabled:
            prof.record_rma(op, nbytes, pattern, n_pes=self.n_pes)
        return f

    @property
    def pending_count(self) -> int:
        """Outstanding non-blocking ops not yet completed by quiet()."""
        return len(self._pending)

    def pending_ops(self) -> tuple[Future, ...]:
        return tuple(self._pending)

    def _issue(self, fn, op: str):
        """Issue an RMA with retry/backoff (DESIGN.md §17): a
        :class:`LinkFailure` is retried up to ``RetryPolicy.max_retries``
        times with exponential backoff; a ``PEFailure`` propagates
        immediately.  The failing op name rides on the raised error."""
        pol = self.shmem.retry
        backoff = pol.backoff_s
        attempt = 0
        while True:
            try:
                return fn()
            except LinkFailure as e:
                attempt += 1
                e.op = op
                if attempt > pol.max_retries:
                    raise
                fault_mod.fault_event(
                    self.shmem._active_profile(), "fault.retries",
                    op=op, attempt=attempt, backoff_us=int(backoff * 1e6))
                prof = self.shmem._active_profile()
                if prof is not None:
                    prof.count("fault.backoff_us", int(backoff * 1e6))
                time.sleep(backoff)
                backoff *= pol.backoff_mult

    def put_nbi(self, x, pattern, local=None) -> Future:
        p = self.compile(pattern)
        return self._enqueue(
            self._issue(lambda: self.shmem.put(x, p, local=local), "put"),
            p, "put", x)

    def get_nbi(self, x, pattern, local=None) -> Future:
        p = self._owner_push(pattern)
        return self._enqueue(
            self._issue(lambda: self.shmem.put(x, p, local=local), "get"),
            p, "get", x)

    def _deadline(self, deadline_s):
        return deadline_s if deadline_s is not None \
            else self.shmem.retry.deadline_s

    def _check_deadline(self, fs, deadline, what: str) -> None:
        delay = max((f.delay_s for f in fs), default=0.0)
        if deadline is not None and delay > deadline:
            slow = max(fs, key=lambda f: f.delay_s)
            fault_mod.fault_event(
                self.shmem._active_profile(), "fault.deadline_exceeded",
                op=slow.op, delay_us=int(delay * 1e6),
                deadline_us=int(deadline * 1e6))
            raise DeadlineExceeded(
                f"{what} deadline {deadline:g}s exceeded: slowest pending "
                f"{slow.op} carries a straggler delay of {delay:g}s",
                pattern=slow.pattern, op=slow.op)

    def quiet(self, *futures: Future, deadline_s: float | None = None):
        """shmem_ctx_quiet: complete THIS context's pending ops — all of
        them, or only `futures` — in issue order, mark them done, drop
        them from the queue and return their values in issue order.
        Other contexts' queues are untouched (per-context isolation).

        `deadline_s` (default: ``RetryPolicy.deadline_s``) bounds the
        completion wait: an op whose straggler delay exceeds it raises
        :class:`~repro_torch.core.fault.DeadlineExceeded` with the queue
        UNTOUCHED; within the deadline the delay is slept.

        With an enabled profiler (and outside CUDA-graph capture), quiet
        waits for the context's device after retiring the ops and
        records one "sync" sample: issue time, then the stall on the
        pending transfers."""
        fs = list(futures) or self._pending
        if not fs:
            return ()
        self._check_deadline(fs, self._deadline(deadline_s), "quiet()")
        delay = max(f.delay_s for f in fs)
        if delay > 0.0:
            fprof = self.shmem._active_profile()
            if fprof is not None:
                fprof.count("fault.straggler_wait_us", int(delay * 1e6))
            time.sleep(delay)
            for f in fs:
                f.delay_s = 0.0
        prof = self.shmem.profile
        timed = prof is not None and prof.enabled and trace_clean()
        t0 = time.perf_counter() if timed else 0.0
        alien = [f for f in fs if not f._done and f not in self._pending]
        if alien:
            raise ValueError(
                "quiet() got futures issued on a different context — "
                "per-context isolation means each context drains its own "
                "queue; call that context's quiet()")
        fs = sorted(fs, key=lambda f: f.seq)     # completion in issue order
        nb = sum(f.nbytes for f in fs)
        if prof is not None and prof.enabled:
            prof.count("quiet.drained", len(fs), nb)
        for f in fs:
            f._done = True
        self._pending = [f for f in self._pending if not f._done]
        if timed:
            t1 = time.perf_counter()
            wait_device(self.shmem.device)
            t2 = time.perf_counter()
            prof.record_sync("quiet", len(fs), nb, issue_s=t1 - t0,
                             stall_s=t2 - t1, n_pes=self.n_pes,
                             t_start=t0 - prof._epoch)
        return tuple(f.value for f in fs)

    def fence(self, *, deadline_s: float | None = None):
        """shmem_ctx_fence: per-destination ordering WITHOUT completion
        (OpenSHMEM §9.10), scoped to THIS context's queue.  Every op is
        issued on the current stream, which already delivers two
        same-destination ops in issue order, so fence completes nothing
        and moves nothing: it checks the deadline (an op known to carry a
        straggler delay beyond it raises ``DeadlineExceeded`` here, at
        the ordering point) and returns the pending values in issue
        order; () when the queue is empty.  An enabled profiler records
        one "sync" sample of issue time only (fence never stalls)."""
        if not self._pending:
            return ()
        self._check_deadline(self._pending, self._deadline(deadline_s),
                             "fence()")
        prof = self.shmem.profile
        timed = prof is not None and prof.enabled and trace_clean()
        t0 = time.perf_counter() if timed else 0.0
        vals = tuple(f.value for f in sorted(self._pending,
                                             key=lambda f: f.seq))
        if timed:
            prof.record_sync("fence", len(self._pending),
                             sum(f.nbytes for f in self._pending),
                             issue_s=time.perf_counter() - t0,
                             stall_s=0.0, n_pes=self.n_pes,
                             t_start=t0 - prof._epoch)
        return vals


class ShmemContext:
    """The library bound to a net: under SIM the whole chip's view (every
    array carries a leading axis of `n_pes` PEs on the net's device),
    under SPMD one PE's (arrays carry this PE's one row)."""

    def __init__(self, net: NetOps, topo: MeshTopology | None = None,
                 use_wand_barrier: bool = False, link=None, embedding=None,
                 profile=None, tuner=None, fault=None, retry=None,
                 fingerprint=None):
        self.net = net
        self.topo = topo
        # the hardware WAND barrier analogue (SPMD backend only; on SIM
        # the dissemination barrier runs either way)
        self.use_wand_barrier = use_wand_barrier
        # alpha-beta LinkModel that algorithm="auto" prices schedules with
        # (None = abmodel.ICI_V5E)
        self.link = link
        # ring embedding policy for this context's collectives (DESIGN.md
        # §12): None = logical rings; "auto"/"snake"/an explicit rank
        # order run ring algorithms in mesh-embedded coordinates
        self.embedding = embedding
        # pcontrol-style profiler (DESIGN.md §13): one op sample per
        # collective, RMA counters, JSON export.  Propagated to the net so
        # raw ppermute traffic lands in its counters.  When None (the
        # default) the hot path pays one `is None` test.
        self.profile = profile
        # measured-performance autotuner: a Tuner (whose DB then also
        # refines ONLINE from this context's profiler samples) or a bare
        # TunedSelector; the choose_* selectors consult it before the
        # analytic model.
        self.tuner = tuner
        self._sel = tuner.selector() if hasattr(tuner, "selector") else tuner
        # `fingerprint` overrides the machine identity collectives tune
        # under (the elastic path's degraded-mesh key, DESIGN.md §17).
        self._fp = fingerprint if fingerprint is not None \
            else tuner_mod.fingerprint(topo, net.n_pes)
        if fingerprint is not None:
            self.refingerprint(fingerprint)
        # retry/backoff policy for nbi RMA + default quiet/fence deadline
        # (DESIGN.md §17); fault= attaches a FaultPlan/FaultInjector to
        # the net so every ppermute consults it.
        self.retry = retry if retry is not None else RetryPolicy()
        self.fault_injector = fault_mod.as_injector(
            fault, topo=topo, profile=profile)
        if self.fault_injector is not None:
            net.fault = self.fault_injector
        if profile is not None:
            net.profile = profile
            if hasattr(tuner, "observe"):
                profile.add_sink(tuner.observe)
        # The default communication context: ShmemContext-level nbi RMA,
        # quiet and fence run on it (DESIGN.md §11).
        self.ctx_default = Ctx(self)

    # -- profiling control (shmem_pcontrol; DESIGN.md §13) -------------------
    def pcontrol(self, level: int) -> None:
        """``shmem_pcontrol``: 0 disables collection, 1 enables counters,
        >= 2 enables the per-op timeline.  Attaches a fresh
        :class:`~repro_torch.core.profile.Profiler` when none was passed
        at construction (so ``ctx.pcontrol(2)`` alone turns profiling
        on)."""
        if self.profile is None:
            if level <= 0:
                return
            self.profile = Profiler(level=level)
            self.net.profile = self.profile
            if hasattr(self.tuner, "observe"):
                self.profile.add_sink(self.tuner.observe)
        else:
            self.profile.pcontrol(level)

    def _active_profile(self):
        p = self.profile
        return p if (p is not None and p.enabled) else None

    # -- elastic re-tuning (DESIGN.md §17) -----------------------------------
    def refingerprint(self, fp: str) -> None:
        """Re-key this context's tuning identity (after the mesh
        degrades).  Profiler op samples and the TunedSelector's DB
        lookups both switch to `fp`, so tuned decisions measured on the
        full mesh stop applying."""
        self._fp = str(fp)
        sel = self._sel
        if sel is not None and hasattr(sel, "with_fingerprint"):
            self._sel = sel.with_fingerprint(self._fp)

    def _group_desc(self, group) -> str:
        if group is None:
            return f"n{self.n_pes}"
        if isinstance(group, team_mod.TeamPartition):
            return f"part{group.n_teams}x{group.size}"
        return f"team{group.size}of{group.world_n}"

    def _prof_op(self, collective: str, x=None, group=None):
        """(context manager, active profiler): the timing wrapper every
        collective method runs under.  One `is None` test when profiling
        is off — the near-zero disabled path.  On the card the op waits
        for the net's device as it opens and closes, so the sample's wall
        time includes the launches it made."""
        prof = self._active_profile()
        if prof is None:
            return _NULL_CM, None
        nbytes = coll._payload_bytes(self.net, x) if x is not None else 0.0
        return prof.op(collective, nbytes=nbytes, n_pes=self.n_pes,
                       team=self._group_desc(group), fingerprint=self._fp,
                       device=self.net.device), prof

    # -- setup / query ------------------------------------------------------
    @property
    def n_pes(self) -> int:
        return self.net.n_pes

    @property
    def device(self) -> torch.device:
        return self.net.device

    def my_pe(self):
        return self.net.my_pe()

    def ptr(self, pe: int, offset: int = 0) -> tuple[int, int]:
        """shmem_ptr: on Epiphany, remote addresses come from shifting the
        core coordinates into the high bits.  The analogue of a 'global
        address' here is the (pe, offset) pair used by static patterns."""
        return (pe % self.n_pes, offset)

    def compile(self, pattern: PatternLike) -> CommPattern:
        """Compile (or pass through) a static (src, dst) pattern for this
        context's PE count — the shmem_init-time schedule precompilation
        (DESIGN.md §9).  Interned: same pattern, same object."""
        return as_pattern(pattern, self.n_pes)

    def _owner_push(self, pattern: PatternLike) -> CommPattern:
        """(requester, owner) pairs -> the compiled owner->requester push
        pattern the IPI-get executes (fan-out reads validate against the
        pattern that actually runs)."""
        if isinstance(pattern, CommPattern):
            return pattern.inverse
        return self.compile([(o, r) for r, o in pattern])

    # -- RMA ------------------------------------------------------------------
    def put(self, x, pattern: PatternLike, local=None):
        """Deliver src's shard to dst for each (src, dst); PEs not addressed
        keep `local` (default: their own x)."""
        p = self.compile(pattern)
        local = x if local is None else local
        recv = self.net.ppermute(x, p)
        return self.net.select(p, recv, local)

    def get(self, x, pattern: PatternLike, local=None):
        """(requester, owner) pairs; owner pushes (IPI-get).  Many
        requesters may name the same owner (fan-out read)."""
        return self.put(x, self._owner_push(pattern), local=local)

    def iput(self, x, pattern, *, sst: int = 1, dst: int = 1,
             nelems: int | None = None, local=None):
        """Strided put (shmem_iput / the paper's §4 strided extension over
        the 2D DMA descriptors): take every sst-th element of the source's
        last axis, deliver to every dst-th slot of the target's."""
        p = self.compile(pattern)
        local = x if local is None else local
        n = nelems if nelems is not None else (x.shape[-1] // max(sst, 1))
        sel = x[..., ::sst][..., :n]
        recv = self.net.ppermute(sel, p)
        upd = local.clone()
        upd[..., :n * dst:dst] = recv
        return self.net.select(p, upd, local)

    def iget(self, x, pattern, **kw):
        return self.iput(x, self._owner_push(pattern), **kw)

    # -- communication contexts (DESIGN.md §11) ------------------------------
    def ctx_create(self, team=None) -> Ctx:
        """shmem_ctx_create / shmem_team_create_ctx: a new communication
        context with a private pending-op queue (team-scoped when `team`
        is given — RMA patterns then use team coordinates)."""
        return Ctx(self, team=team)

    @property
    def _pending(self) -> list[Future]:
        return self.ctx_default._pending

    @property
    def pending_count(self) -> int:
        """Outstanding nbi ops on the DEFAULT context."""
        return self.ctx_default.pending_count

    def pending_ops(self) -> tuple[Future, ...]:
        return self.ctx_default.pending_ops()

    def put_nbi(self, x, pattern, local=None) -> Future:
        return self.ctx_default.put_nbi(x, pattern, local=local)

    def get_nbi(self, x, pattern, local=None) -> Future:
        return self.ctx_default.get_nbi(x, pattern, local=local)

    def quiet(self, *futures: Future, deadline_s: float | None = None):
        """shmem_quiet on the DEFAULT context (see Ctx.quiet)."""
        return self.ctx_default.quiet(*futures, deadline_s=deadline_s)

    def fence(self, *, deadline_s: float | None = None):
        """shmem_fence on the DEFAULT context (see Ctx.fence)."""
        return self.ctx_default.fence(deadline_s=deadline_s)

    # -- teams (OpenSHMEM 1.4+; DESIGN.md §11) -------------------------------
    def team_world(self) -> team_mod.Team:
        return team_mod.team_world(self.n_pes)

    def team_split_strided(self, parent: team_mod.Team | None, start: int,
                           stride: int, size: int) -> team_mod.Team:
        """shmem_team_split_strided over `parent` (None = world)."""
        parent = parent if parent is not None else self.team_world()
        return team_mod.split_strided(parent, start, stride, size)

    def team_split_2d(self, topo: MeshTopology | None = None,
                      axis: int = -1) -> team_mod.TeamPartition:
        """Row (axis=-1) / column (axis=0) teams of this context's
        topology — the partition the hierarchical collectives run over."""
        topo = topo if topo is not None else self.topo
        if topo is None:
            raise ValueError("team_split_2d needs a topology (pass topo= "
                             "or build the context with one)")
        return team_mod.split_2d(self.team_world(), topo, axis)

    def _resolve_team(self, team, pe_start, log_pe_stride, pe_size):
        """The 1.3 active-set shim: ``(PE_start, logPE_stride, PE_size)``
        resolves to the interned Team the explicit API names.  A world
        team short-circuits to the flat path (identical schedules, and it
        keeps pipelined execution available)."""
        if pe_size is not None or pe_start is not None or log_pe_stride:
            if team is not None:
                raise ValueError("pass team= OR an active set, not both")
            if pe_size is None:
                raise ValueError("an active set needs PE_size")
            team = team_mod.from_active_set(pe_start or 0, log_pe_stride,
                                            pe_size, self.n_pes)
        if (isinstance(team, team_mod.Team)
                and team.members == tuple(range(self.n_pes))):
            return None     # identity ranks: the flat path IS the world team
        return team

    # -- collectives ----------------------------------------------------------
    def barrier_all(self, token=None):
        """WAND hardware barrier analogue (a zero-token axis_psum over
        the group) when enabled on the SPMD backend, else the
        dissemination software barrier."""
        if self.use_wand_barrier and isinstance(self.net, SpmdNetOps):
            tok = torch.zeros(1, dtype=torch.int32, device=self.device) \
                if token is None else token
            return self.net.axis_psum(tok)
        return coll.barrier(self.net, token)

    def barrier(self, token=None, team=None, algorithm=None):
        """algorithm: None/"dissem" (the paper's dissemination barrier),
        "tree" (binomial gather + broadcast), or "auto" (congestion-model
        pick between the two)."""
        cm, prof = self._prof_op("barrier", group=team)
        with cm:
            return coll.barrier(self.net, token, team=team,
                                algorithm=algorithm, topo=self.topo,
                                link=self.link, profile=prof)

    def broadcast(self, x, root: int = 0, pipeline_chunks=None, team=None):
        """With `team`, `root` is a TEAM rank; non-members keep x."""
        cm, prof = self._prof_op("broadcast", x, team)
        with cm:
            return coll.broadcast(self.net, x, root,
                                  pipeline_chunks=pipeline_chunks,
                                  topo=self.topo, link=self.link, team=team,
                                  profile=prof, tuner=self._sel)

    def collect(self, x, axis: int = 0, pipeline_chunks=None, team=None):
        cm, prof = self._prof_op("collect", x, team)
        with cm:
            return coll.collect(self.net, x, axis,
                                pipeline_chunks=pipeline_chunks,
                                topo=self.topo, link=self.link, team=team,
                                embedding=self.embedding,
                                profile=prof, tuner=self._sel)

    def fcollect(self, x, axis: int = 0, algorithm=None,
                 pipeline_chunks=None, team=None):
        cm, prof = self._prof_op("fcollect", x, team)
        with cm:
            return coll.fcollect(self.net, x, axis, algorithm,
                                 pipeline_chunks=pipeline_chunks,
                                 topo=self.topo, link=self.link, team=team,
                                 embedding=self.embedding,
                                 profile=prof, tuner=self._sel)

    def to_all(self, x, op: str = "sum", algorithm=None,
               pipeline_chunks=None, team=None, partition=None,
               PE_start=None, logPE_stride: int = 0, PE_size=None):
        """shmem_TYPE_OP_to_all.  algorithm="auto" prices the candidate
        schedules against this context's topology and link model
        (DESIGN.md §9); pipeline_chunks="auto" additionally prices chunked
        double-buffered execution and picks the chunk count (§10) —
        bit-identical to monolithic, whatever is selected.

        Grouping (DESIGN.md §11): `team` scopes the reduction to a Team's
        members (non-members pass through); the OpenSHMEM 1.3 active-set
        triple ``(PE_start, logPE_stride, PE_size)`` resolves to the same
        interned Team as the explicit team API.  `partition` adds the
        hierarchical two-level schedule to the "auto" candidates
        (algorithm="hier" forces it)."""
        team = self._resolve_team(team, PE_start, logPE_stride, PE_size)
        cm, prof = self._prof_op("allreduce", x,
                                 team if team is not None else partition)
        with cm:
            return coll.allreduce(self.net, x, op, algorithm=algorithm,
                                  topo=self.topo, link=self.link,
                                  pipeline_chunks=pipeline_chunks,
                                  team=team, partition=partition,
                                  embedding=self.embedding,
                                  profile=prof, tuner=self._sel)

    def reduce_scatter(self, x, op: str = "sum", team=None):
        cm, prof = self._prof_op("reduce_scatter", x, team)
        with cm:
            return coll.reduce_scatter(self.net, x, op, team=team,
                                       profile=prof)

    def alltoall(self, x, axis: int = 0, pipeline_chunks=None, team=None):
        cm, prof = self._prof_op("alltoall", x, team)
        with cm:
            return coll.alltoall(self.net, x, axis,
                                 pipeline_chunks=pipeline_chunks,
                                 topo=self.topo, link=self.link, team=team,
                                 profile=prof, tuner=self._sel)

    # -- atomics (§3.5) ---------------------------------------------------------
    def testset(self, var, value):
        """The TESTSET primitive: atomically 'test-if-not-zero and
        conditional write'.  Local (per-PE) flavor; remote flavors compose
        it with put/get patterns."""
        return var, torch.where(var == 0, value, var)

    def atomic_fetch_add(self, var, contrib, pattern: PatternLike):
        """Each (requester, target): requester adds `contrib` to target's
        `var`, fetching the pre-update value.  One requester per target per
        call (a permutation pattern — e.g. the paper's Fig. 5 'tight loop
        on the next neighboring PE').  Returns (fetched, new_var)."""
        p = self.compile(pattern)
        delivered = self.net.ppermute(contrib, p)
        fetched = self.net.ppermute(var, p.inverse)
        new_var = self.net.select(p, var + delivered, var)
        return fetched, new_var

    def atomic_fetch_add_shared(self, var, contrib):
        """All PEs atomically add to the *same* symmetric var (owned
        replicated): returns per-PE fetched old value under the
        deterministic PE ordering (exclusive scan) and the final var."""
        prefix = coll.exclusive_scan(self.net, contrib, "sum")
        total = coll.allreduce(self.net, contrib, "sum")
        return var + prefix, var + total

    def atomic_swap(self, var, value, pattern):
        p = self.compile(pattern)
        delivered = self.net.ppermute(value, p)
        fetched = self.net.ppermute(var, p.inverse)
        return fetched, self.net.select(p, delivered, var)

    def atomic_compare_swap(self, var, cond, value, pattern):
        p = self.compile(pattern)
        delivered = self.net.ppermute(value, p)
        dcond = self.net.ppermute(cond, p)
        fetched = self.net.ppermute(var, p.inverse)
        swapped = torch.where(var == dcond, delivered, var)
        return fetched, self.net.select(p, swapped, var)

    # -- locks (§3.7) -------------------------------------------------------
    # The lock lives on PE 0 (as in the paper).  The arbitration among
    # simultaneous requesters is PE order — the observable semantics of
    # TESTSET polling with deterministic timing.
    def set_lock(self, lock, want):
        """lock: symmetric int32 (0 = free, else 1+holder).  want: per-PE
        bool.  Returns (granted: per-PE bool, new_lock)."""
        pe = self.my_pe()
        ids = torch.where(want, pe + 1, torch.full_like(pe, self.n_pes + 1))
        winner = coll.allreduce(self.net, ids.to(torch.int32), "min")
        free = lock == 0
        granted = free & want & (winner == pe + 1)
        new_lock = torch.where(free & (winner <= self.n_pes),
                               winner.to(lock.dtype), lock)
        return granted, new_lock

    def test_lock(self, lock, want):
        """Non-blocking acquire: same as set_lock but losers simply fail
        (return False) instead of spinning."""
        return self.set_lock(lock, want)

    def clear_lock(self, lock, holder_releases):
        pe = self.my_pe()
        is_holder = lock == (pe + 1).to(lock.dtype)
        release = coll.allreduce(
            self.net, (is_holder & holder_releases).to(torch.int32), "max")
        return torch.where(release > 0, torch.zeros_like(lock), lock)

    # -- critical section combinator -----------------------------------------
    def critical(self, state, fn):
        """Serialize fn over PEs in rank order: PE k applies fn to the
        state produced by PE k-1 (lock-protected update region analogue)."""
        n = self.n_pes
        for turn in range(n):
            updated = fn(state)
            mine = self.net.select(np.arange(n) == turn, updated, state)
            state = coll.broadcast(self.net, mine, root=turn)
        return state


def spmd_ctx(axis, topo=None, **kw) -> ShmemContext:
    """This rank's PE of the group over mesh `axis` (inside a rank process
    of `core.spmd.run`, after `launch.mesh.make_mesh`): arrays carry this
    PE's one row on their leading axis."""
    return ShmemContext(rank_net(axis), topo, **kw)


def sim_ctx(n_pes: int, topo=None, noc: bool = False, device=None,
            **kw) -> ShmemContext:
    """`n_pes` PEs simulated on one device (the CUDA card unless
    `device` says otherwise; without a card and without that request it
    raises).  noc=True simulates the NoC's link contention: patterns
    execute as link-disjoint waves (netops.NocSimNetOps) — bit-identical
    results, congestion-scaled traffic."""
    net = NocSimNetOps(n_pes, device, topo=topo) if noc \
        else SimNetOps(n_pes, device)
    return ShmemContext(net, topo, **kw)
