"""Continuous-batching serving engine on the paged symmetric-heap KV
cache.  Counterpart of `repro/serve/engine.py`.

  * `Scheduler` — the pure-host continuous-batching policy.  Strict-FIFO
    admission into fixed engine slots with worst-case page reservation
    (prompt + max_new tokens) at admission time, per-step join/evict.
  * `PagedKV`/`PagePool` (serve/kv.py) — page bookkeeping on the
    symmetric heap.  Heap pressure is admission backpressure: a request
    that doesn't fit waits at the queue head (no skipping, so no
    starvation), and no `HeapError` ever escapes the engine.
  * `ServeEngine` — the device half: a paged prefill (ONE forward pass
    over the prompt bucket that fills the sequence's KV pages, attending
    through the flash-attention kernel on the card) plus a fixed-shape
    batched decode step over all slots.  Inactive slots ride along masked
    (their page-table rows point at the reserved null page).  Every
    per-row op is batch-independent and the decode shape never changes,
    so a request's greedy tokens are bit-identical whether it runs alone
    or joins mid-batch.

Observability (DESIGN.md §16): a `ServeMetrics` (`metrics=`) records the
request lifecycle (submit, admit, first token, decode steps, evict,
admission backpressure); a `Profiler` or `Tracer` (`profile=`) times
``serve.step``/``serve.prefill``/``serve.decode`` spans that wait for the
card, and a tracer also draws each request on its async track (begin,
``admit``, ``first_token``, end).  Both default to None: zero cost.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..core.heap import SymmetricHeap
from ..core.trace import Tracer
from ..models import layers as L
from ..models import transformer
from ..parallel.comm import Comm
from . import step as sstep
from .kv import PagedKV, PagePool, pages_for


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int


@dataclasses.dataclass
class SlotState:
    rid: int
    prompt: np.ndarray
    max_new: int
    pos: int                     # next position to be written by decode
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class Scheduler:
    """Deterministic continuous-batching policy (pure host code).

    Admission is strict FIFO: free slots are filled in slot-index order
    from the queue head, stopping at the first request whose worst-case
    page reservation does not fit — the head is never skipped.  Eviction
    scans slots in index order each step."""

    def __init__(self, kv: PagedKV, page_size: int):
        self.kv = kv
        self.page_size = int(page_size)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[SlotState | None] = [None] * kv.max_slots
        self._next_rid = 0
        self.n_admitted = 0
        self.n_evicted = 0

    def pages_needed(self, req: Request) -> int:
        return pages_for(len(req.prompt) + req.max_new, self.page_size)

    def submit(self, prompt, max_new: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        req = Request(self._next_rid, prompt, int(max_new))
        if self.pages_needed(req) > self.kv.max_pages:
            raise ValueError(
                f"request needs {self.pages_needed(req)} pages "
                f"> max_pages={self.kv.max_pages}")
        self._next_rid += 1
        self.queue.append(req)
        return req.rid

    def step_evict(self) -> list[tuple[int, SlotState]]:
        """Evict finished sequences (slot-index order), freeing their
        pages back to the pool."""
        out = []
        for i, st in enumerate(self.slots):
            if st is not None and st.done:
                self.kv.evict(i)
                self.slots[i] = None
                self.n_evicted += 1
                out.append((i, st))
        return out

    def step_admit(self) -> list[tuple[int, SlotState]]:
        """Admit queued requests into free slots while pages last."""
        out = []
        for slot, st in enumerate(self.slots):
            if st is not None or not self.queue:
                continue
            req = self.queue[0]
            need = self.pages_needed(req)
            if not self.kv.can_admit(need):
                break           # backpressure: head waits, nobody skips
            self.queue.popleft()
            self.kv.admit(slot, req.rid, need,
                          len(req.prompt) + req.max_new)
            state = SlotState(rid=req.rid, prompt=req.prompt,
                              max_new=req.max_new, pos=len(req.prompt))
            self.slots[slot] = state
            self.n_admitted += 1
            out.append((slot, state))
        return out

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.done]

    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)


class ServeEngine:
    """Continuous-batching engine: paged prefill + fixed-shape batched
    decode over `max_slots` sequences, greedy sampling.

    Runs on `device` (default CUDA; raises without a card unless
    `device="cpu"`).  `params` default to the port's seeded init
    (`init_seed`).  `kv_heap_bytes` caps the symmetric-heap KV region —
    by default sized to hold every slot's worst-case sequence plus the
    null page; the KV pool on the device holds that many pages.
    `profile`/`metrics` attach the observability layer (module
    docstring); `tuner` rides on the engine's `Comm`, whose axes all
    have size 1 on one device, so no collective consults it."""

    def __init__(self, cfg, *, params=None, device=None, max_slots: int = 4,
                 page_size: int = 8, max_seq: int = 64,
                 prompt_bucket: int = 32, kv_heap_bytes: int | None = None,
                 eos_id: int | None = None, init_seed: int = 0,
                 capture_logits: bool = False, tuner=None, profile=None,
                 metrics=None):
        if cfg.family not in transformer.paged_families():
            raise ValueError(
                f"paged serving supports {transformer.paged_families()}, "
                f"not {cfg.family!r}")
        if prompt_bucket > max_seq:
            raise ValueError("prompt_bucket must be <= max_seq")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page_size = int(page_size)
        self.max_seq = int(max_seq)
        self.prompt_bucket = int(prompt_bucket)
        self.max_slots = int(max_slots)
        self.eos_id = eos_id
        self.capture_logits = capture_logits
        self.comm = Comm(tuner=tuner, profile=profile)
        self.profile = profile
        self.metrics = metrics
        self._trace = profile if isinstance(profile, Tracer) else None

        max_pages = pages_for(max_seq, page_size)
        _, nkv, _ = L._gqa_dims(cfg, self.comm.axis_size(self.comm.axes.model))
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        page_bytes = 2 * cfg.n_layers * page_size * nkv * cfg.hd * itemsize
        if kv_heap_bytes is None:
            kv_heap_bytes = page_bytes * (max_slots * max_pages + 1)
        self.page_bytes = page_bytes
        self.heap = SymmetricHeap(int(kv_heap_bytes))
        pool = PagePool(self.heap, page_bytes)
        if pool.num_pages < 2:
            raise ValueError(
                f"kv_heap_bytes={kv_heap_bytes} holds {pool.num_pages} "
                f"pages of {page_bytes}B; need >= 2 (null + one live)")
        self.kv = PagedKV(pool, max_slots, max_pages)
        self.scheduler = Scheduler(self.kv, page_size)
        self.results: dict[int, np.ndarray] = {}
        self.logits_trace: dict[int, list] = {}
        self.steps = 0

        if params is None:
            params = transformer.init_params(cfg, seed=init_seed,
                                             device=self.device)
        self.params = params
        self.pool = transformer.init_kv_pool(cfg, 1, pool.num_pages,
                                             page_size, self.device)

    # -- observability helpers ------------------------------------------------
    def _span(self, name: str, **meta):
        """Nested tracer span, bare profiler op, or nothing — the whole
        disabled cost is this attribute test.  Enabled spans wait for the
        engine's device as they open and close."""
        if self._trace is not None and self._trace.enabled:
            return self._trace.span(name, device=self.device, **meta)
        if self.profile is not None and self.profile.enabled:
            return self.profile.op(name, kind="span", device=self.device)
        return contextlib.nullcontext()

    def _req_event(self, kind: str, rid: int, **args) -> None:
        """Request-lifecycle edge on the tracer's async request track."""
        t = self._trace
        if t is None or not t.enabled:
            return
        if kind == "enqueue":
            t.begin_async("request", rid, f"req {rid}", **args)
        elif kind == "evict":
            t.end_async("request", rid, f"req {rid}", **args)
        else:
            t.instant_async("request", rid, kind, **args)

    # -- client API -----------------------------------------------------------
    def submit(self, prompt, max_new: int) -> int:
        if len(np.asarray(prompt).reshape(-1)) > self.prompt_bucket:
            raise ValueError(
                f"prompt longer than prompt_bucket={self.prompt_bucket}")
        rid = self.scheduler.submit(prompt, max_new)
        if self.metrics is not None:
            self.metrics.on_submit(rid)
        self._req_event("enqueue", rid, prompt_len=len(
            np.asarray(prompt).reshape(-1)), max_new=int(max_new))
        return rid

    def _emit(self, st: SlotState, tok: int, lg=None) -> None:
        st.out.append(int(tok))
        if self.capture_logits:
            self.logits_trace.setdefault(st.rid, []).append(
                lg.float().cpu().numpy())
        if (len(st.out) >= st.max_new
                or (self.eos_id is not None and int(tok) == self.eos_id)):
            st.done = True

    def _tensor(self, a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    @torch.no_grad()
    def step(self) -> dict:
        """One engine iteration: evict -> admit(+prefill) -> batched
        decode.  Returns {"evicted": [...], "admitted": [...],
        "decoded": n_active}."""
        sched, cfg = self.scheduler, self.cfg
        metrics = self.metrics
        with self._span("serve.step", n_pes=0):
            evicted = []
            for slot, st in sched.step_evict():
                self.results[st.rid] = np.asarray(st.out, np.int32)
                evicted.append(st.rid)
                if metrics is not None:
                    metrics.on_evict(st.rid)
                self._req_event("evict", st.rid, n_tokens=len(st.out))

            admitted = []
            admits = sched.step_admit()
            if metrics is not None and sched.queue \
                    and any(s is None for s in sched.slots):
                # free slot + waiting head = page backpressure, the only
                # reason FIFO admission stalls
                metrics.on_backpressure()
            for slot, st in admits:
                if metrics is not None:
                    metrics.on_admit(st.rid)
                self._req_event("admit", st.rid, slot=slot)
                Lb = self.prompt_bucket
                toks = np.zeros((1, Lb), np.int64)
                toks[0, :len(st.prompt)] = st.prompt
                positions = torch.arange(Lb, device=self.device).expand(1, Lb)
                with self._span("serve.prefill", nbytes=float(Lb * 4)):
                    logits, self.pool = transformer.prefill_paged(
                        self.comm, cfg, self.params, self.pool,
                        self._tensor(self.kv.table[slot:slot + 1]),
                        self._tensor(toks), positions,
                        page_size=self.page_size)
                    lg = logits[:, len(st.prompt) - 1]            # (1, V)
                    tok = int(sstep.sample_greedy(self.comm, lg)[0])
                self._emit(st, tok, lg[0])
                if metrics is not None:
                    metrics.on_first_token(st.rid)
                self._req_event("first_token", st.rid)
                admitted.append(st.rid)

            active = sched.active_slots()
            if active:
                toks = np.zeros((self.max_slots, 1), np.int64)
                poss = np.zeros((self.max_slots,), np.int64)
                for i in active:
                    st = sched.slots[i]
                    toks[i, 0] = st.out[-1]
                    poss[i] = st.pos
                t0 = time.perf_counter()
                with self._span("serve.decode", n_pes=len(active)):
                    logits, self.pool = transformer.decode_step_paged(
                        self.comm, cfg, self.params, self.pool,
                        self._tensor(self.kv.table), self._tensor(toks),
                        self._tensor(poss), page_size=self.page_size)
                    lg = logits[:, 0]
                    tok = sstep.sample_greedy(self.comm, lg).cpu().numpy()
                if metrics is not None:
                    metrics.on_decode_step(len(active),
                                           time.perf_counter() - t0)
                for i in active:
                    st = sched.slots[i]
                    st.pos += 1
                    self._emit(st, tok[i], lg[i])
        self.steps += 1
        if metrics is not None:
            metrics.sample_engine(self)
        return {"evicted": evicted, "admitted": admitted,
                "decoded": len(active)}

    def run(self, max_steps: int = 100_000) -> dict[int, np.ndarray]:
        """Drain queue and slots; returns {rid: generated tokens}."""
        for _ in range(max_steps):
            if self.scheduler.idle():
                break
            self.step()
        # final evict pass so the last finishers land in results
        for slot, st in self.scheduler.step_evict():
            self.results[st.rid] = np.asarray(st.out, np.int32)
            if self.metrics is not None:
                self.metrics.on_evict(st.rid)
            self._req_event("evict", st.rid, n_tokens=len(st.out))
        return self.results
