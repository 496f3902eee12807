"""Async checkpointing ON the PGAS substrate (DESIGN.md §17); port of
`repro/ckpt/pgas.py`.

The thread-based async save in :mod:`repro_torch.ckpt.manager` is a
host-side workaround; the substrate the paper defines (arXiv:1608.03545
§3.2's symmetric heap + arXiv:1604.04205's inter-processor DMA) already
has the right machinery: non-blocking ``put_nbi`` on a DEDICATED
communication context (``shmem_ctx_create``), ordered by the pending-op
engine and completed by ``ctx.quiet()`` only at the epoch boundary.

:class:`PgasCheckpointer` streams every PE's shard of the train state to
a gather PE as a chain of ring rotations (patterns need unique
destinations, so a direct all-to-one fan-in is illegal — the same
fcollect-style rotation the collectives use), overlapping the stream
with subsequent train steps:

    ck.begin(step, state)      # hand the descriptor chain to the engine
    ... more train steps ...   # the 'DMA engine' moves shards
    ck.drain()                 # epoch boundary: ctx.quiet() + write

Two overlap mechanisms compose:

  * per-context isolation (DESIGN.md §11): the rotations ride a PRIVATE
    context, so the train step's own collectives and quiet() calls never
    drain (or stall behind) checkpoint traffic;
  * asynchronous issue (``async_issue=True``, the default): ``begin()``
    pins the state and wakes a dedicated worker thread — the SIM
    analogue of the e-DMA engine walking a descriptor list after one
    doorbell write.  The worker launches each rotation (one put_copy
    kernel on the card) on the stream that was current at ``begin()``,
    so device order is the caller's; ``begin()`` itself costs the pin's
    launches and a thread start.  ``async_issue=False`` issues on the
    caller's thread — deterministic interleaving for the
    fault-injection tests.

Torch tensors are mutable, so ``begin()`` pins what it was given: each
leaf with a leading PE axis is cloned on its device (one copy, queued
before anything the caller issues next), and every other leaf is copied
to the host.  A caller may write its state in place right after
``begin()`` returns.

SIM-oriented, like ``Tuner.tune``: leaves carry the leading PE axis and
the gather PE's rows are reconstructed on the host into global arrays at
drain — each rotation's row of the gather PE is sliced on the device and
only that row crosses to the host — then written through the atomic
:func:`repro_torch.ckpt.manager.save`.

Fault semantics: the worker issues through the same ``Ctx.put_nbi``
retry/backoff engine as any other RMA, so injected link drops retry with
backoff and a dead PE raises :class:`~repro_torch.core.fault.PEFailure`
— the error is captured by the in-flight task and re-raised at
:meth:`drain`, the stream's completion point.  ``put_copy.launches``
counts the worker's launches too: read it after :meth:`drain`.
"""
from __future__ import annotations

import contextlib
import pathlib
import threading

import numpy as np
import torch

from . import manager


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


class PgasCheckpointer:
    """Overlapped checkpoint stream on a dedicated PGAS context.

    shmem       : the :class:`~repro_torch.core.shmem.ShmemContext`
                  (SIM/NoC-SIM)
    ckpt_dir    : where :func:`repro_torch.ckpt.manager.save` lands the
                  result
    gather_pe   : the PE whose symmetric-heap region accumulates shards
    order       : ring order for the rotations (default: the topology's
                  snake embedding, so every rotation hop is one mesh hop)
    async_issue : True (default) issues the rotations on a dedicated
                  worker thread so ``begin()`` returns immediately;
                  False issues inline on the caller's thread
    """

    def __init__(self, shmem, ckpt_dir, gather_pe: int = 0, order=None,
                 async_issue: bool = True):
        self.shmem = shmem
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.gather_pe = int(gather_pe)
        self.async_issue = bool(async_issue)
        n = shmem.n_pes
        if order is None:
            topo = shmem.topo
            order = (topo.snake_order()
                     if topo is not None
                     and getattr(topo, "n_pes", None) == n
                     else tuple(range(n)))
        self.order = tuple(int(p) for p in order)
        if sorted(self.order) != list(range(n)):
            raise ValueError(f"order must be a permutation of 0..{n - 1}")
        # the dedicated context: checkpoint traffic gets its own pending
        # queue, invisible to the train step's quiet()/fence()
        self.ctx = shmem.ctx_create()
        self.fwd = self.ctx.compile(
            [(self.order[i], self.order[(i + 1) % n]) for i in range(n)])
        self._inflight = None
        self._worker: threading.Thread | None = None
        self._issued: dict[str, tuple] | None = None
        self._error: BaseException | None = None

    @property
    def pending(self) -> int:
        """Outstanding checkpoint rotations not yet completed — the
        dedicated context's pending-op queue depth."""
        return self.ctx.pending_count

    @property
    def in_flight(self) -> bool:
        """A begun checkpoint stream has not been drained yet."""
        return self._inflight is not None

    # -- the descriptor-chain walk (runs on the worker when async) -----------
    def _issue_all(self, work: list[tuple[str, torch.Tensor]],
                   stream=None) -> None:
        n = self.shmem.n_pes
        try:
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                out: dict[str, tuple] = {}
                for name, arr in work:
                    cur, futs = arr, []
                    for _ in range(1, n):
                        f = self.ctx.put_nbi(cur, self.fwd)
                        cur = f.value      # chained: rotation k feeds k+1
                        futs.append(f)
                    out[name] = (arr, futs)
            self._issued = out
        except BaseException as e:          # surfaces at drain()
            self._error = e

    def _join_issue(self) -> dict[str, tuple]:
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            self._inflight = None
            raise err
        issued, self._issued = self._issued, None
        return issued or {}

    def begin(self, step: int, state, meta: dict | None = None) -> int:
        """Queue the checkpoint stream for `state` WITHOUT completing it
        — returns immediately with the number of rotations the stream
        will issue.  A previous in-flight checkpoint is drained first (at
        most one epoch of overlap, like double-buffered DMA
        descriptors)."""
        if self._inflight is not None:
            self.drain()
        n = self.shmem.n_pes
        work: list[tuple[str, torch.Tensor]] = []
        replicated: list[tuple[str, object]] = []
        for name, leaf in manager._leaf_paths(state):
            shp = getattr(leaf, "shape", ())
            if len(shp) >= 1 and shp[0] == n:
                # pinned: the caller may write the tensor in place as
                # soon as begin() returns
                work.append((name, leaf.detach().clone()))
            else:
                replicated.append((name, manager._host_copy(leaf)))
        self._inflight = (int(step), replicated, meta)
        dev = self.shmem.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" \
            else None
        if self.async_issue:
            self._worker = threading.Thread(
                target=self._issue_all, args=(work, stream), daemon=False)
            self._worker.start()
        else:
            self._issue_all(work)
        prof = self.shmem._active_profile()
        if prof is not None:
            prof.count("ckpt.pgas_begin", 1)
        return len(work) * (n - 1)

    def _gather(self, rotations: dict[str, tuple]) -> dict[str, object]:
        """The global host arrays the gather PE holds once every rotation
        has landed: its own row, then the row that arrived k hops behind
        it on the ring from rotation k.  Only the gather PE's row of each
        rotation leaves the device."""
        n = self.shmem.n_pes
        gp = self.gather_pe
        gi = self.order.index(gp)
        flat: dict[str, object] = {}
        for name, (own, futs) in rotations.items():
            out = torch.empty(own.shape, dtype=own.dtype, device="cpu")
            out[gp].copy_(own[gp])                  # k=0: own shard
            for k, f in enumerate(futs, start=1):
                src = self.order[(gi - k) % n]      # k hops behind on ring
                out[src].copy_(f.value[gp])
            flat[name] = out
        return flat

    def drain(self) -> pathlib.Path | None:
        """Epoch boundary: join the issue worker, ``ctx.quiet()`` the
        dedicated context (the ONLY completion point of the stream),
        reconstruct the global arrays from the gather PE's accumulated
        rows, and write them through the atomic :func:`manager.save`.
        Returns the checkpoint path, or None when nothing is in flight.
        A fault captured by the stream (dead PE, unhealable link)
        re-raises here — the completion point."""
        if self._inflight is None:
            return None
        rotations = self._join_issue()
        step, replicated, meta = self._inflight
        self._inflight = None
        self.ctx.quiet()
        flat = self._gather(rotations)
        del rotations                   # frees the rotated device copies
        for name, arr in replicated:
            flat[name] = arr
        prof = self.shmem._active_profile()
        if prof is not None:
            prof.count("ckpt.pgas_drain", 1,
                       float(sum(_nbytes(a) for a in flat.values())))
        return manager.save(self.ckpt_dir, step, flat, extra_meta=meta)


__all__ = ["PgasCheckpointer"]
