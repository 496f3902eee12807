"""The rank runtime of the SPMD backend: one process per PE, every PE's
receive slots in one symmetric heap.

This is the machinery `jax.shard_map` gives the reference.  On an
Epiphany each PE is a core of the same chip and a put is a store into
another core's memory; here each PE is a process on the same device (the
CUDA card, or the CPU), and a put is a store by the sending PE's kernel
into the destination PE's slot of a heap every process maps:

  * `SymmetricHeap` — one uint8 allocation of shape (n_pes, 2,
    slot_bytes): a receive slot per PE, double-buffered (two banks).  On
    the card the parent allocates it and the ranks map it by CUDA IPC (a
    CUDA tensor handed to a spawned process is shared, not copied); on
    the CPU it is a `share_memory_()` tensor.
  * `run(fn, n, ...)` — spawns `n` rank processes (`torch.multiprocessing`,
    the spawn context), gives each its rank, the heap and a gloo process
    group, runs ``fn(*args)`` in each and returns the ranks' results.
    Under the paper's runtime gloo carries host rendezvous and barriers
    only, never a payload; the library backend (`Comm(backend="xla")`)
    runs its collectives over gloo groups of the mesh's axes.
    A rank that raises makes `run` raise (the other ranks are ended).
    No process that `run` started outlives it.
  * `current()` — inside a rank process: its `RankContext` (rank, world
    size, heap, device, the rank mesh `launch.mesh.make_mesh` set up,
    and the torch.distributed groups of the mesh's axes that the
    library backend, `Comm(backend="xla")`, runs its collectives over:
    `RankContext.axis_group`).
  * `meta_rank(mesh)` — one rank of `mesh` in this process, on PyTorch's
    "meta" device (shapes and dtypes, no storage): no process is
    spawned, no barrier is passed and no library call is made, but every
    heap round and library collective the rank's program issues is
    counted as the rank would count it (`MetaRank`).  `launch/dryrun.py`
    traces one rank's step of a production mesh this way.

A delivery round (`netops.SpmdNetOps.ppermute`) is: every source stores
its payload into its destination's slot of the current bank; then the
stream is synchronised and all ranks pass a host barrier; then every
destination reads its slot.  Banks alternate every round, so a slot is
written again only after its reader has passed the next barrier.  The
barrier spans every rank: each rank runs the same sequence of rounds (the
program is SPMD), and rounds over different mesh axes write the same
slots, so a barrier over one axis group would not order them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import tempfile
import time
from datetime import timedelta

import torch

from .. import resolve_device

# Default receive-slot size on the card: the trainer's gradient bucket
# (`train/step.BUCKET_BYTES`), so one bucket moves in one round.  On the
# CPU (tests, smoke runs) slots are small and payloads cross in chunks.
SLOT_BYTES = 64 * 1024 * 1024
CPU_SLOT_BYTES = 1024 * 1024

# How long a rank waits at a host barrier before gloo gives up.
BARRIER_TIMEOUT_S = 600.0


class SymmetricHeap:
    """A receive slot per PE, double-buffered: `buf` is (n_pes, 2,
    slot_bytes) uint8 on one device, mapped by every rank process."""

    def __init__(self, buf: torch.Tensor):
        if buf.dtype != torch.uint8 or buf.dim() != 3 or buf.shape[1] != 2:
            raise ValueError(f"a heap is (n_pes, 2, slot_bytes) uint8, not "
                             f"{tuple(buf.shape)} {buf.dtype}")
        self.buf = buf

    @classmethod
    def allocate(cls, n_pes: int, slot_bytes: int | None = None,
                 device=None) -> "SymmetricHeap":
        """The heap of `n_pes` PEs on `device` (the card unless the
        caller asks for the CPU), slots of `slot_bytes` (default
        SLOT_BYTES on the card, CPU_SLOT_BYTES on the CPU); a CPU heap
        lives in shared memory."""
        dev = resolve_device(device)
        if slot_bytes is None:
            slot_bytes = SLOT_BYTES if dev.type == "cuda" else CPU_SLOT_BYTES
        buf = torch.zeros((n_pes, 2, slot_bytes), dtype=torch.uint8,
                          device=dev)
        if dev.type == "cpu":
            buf.share_memory_()
        return cls(buf)

    @property
    def n_pes(self) -> int:
        return self.buf.shape[0]

    @property
    def slot_bytes(self) -> int:
        return self.buf.shape[2]

    def slot(self, pe: int, bank: int) -> torch.Tensor:
        """PE `pe`'s receive slot in `bank`: a 1-D uint8 view."""
        return self.buf[pe, bank]


@dataclasses.dataclass
class RankContext:
    """What a rank process knows: its rank, the world size, the heap,
    its device, and the rank mesh (`launch.mesh`) once one is made."""
    rank: int
    world: int
    heap: SymmetricHeap
    device: torch.device
    mesh: object = None
    rounds: int = 0            # delivery rounds so far: the bank counter
    sync_s: float = 0.0        # host seconds spent in `barrier` so far
    lib_calls: int = 0         # library collectives so far (`lib_call`)
    lib_s: float = 0.0         # host seconds spent in them so far
    groups: dict = dataclasses.field(default_factory=dict)

    def next_bank(self) -> int:
        """The bank of the next delivery round (alternating)."""
        bank = self.rounds % 2
        self.rounds += 1
        return bank

    def barrier(self) -> None:
        """Every rank's stores of this round are complete and visible:
        the stream is synchronised, then all ranks meet on the host.
        `sync_s` accumulates the host time this takes (the wait for this
        rank's queued device work, then for the other ranks)."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.current_stream().synchronize()
        torch.distributed.barrier()
        self.sync_s += time.perf_counter() - t0

    def axis_group(self, mesh, axis) -> "AxisGroup":
        """This rank's torch.distributed group over `axis` (a name, or a
        tuple flattened as `mesh.group` flattens it) of `mesh`, made once
        per rank and cached by the mesh's shape and the axis.  Making a
        group is collective over the whole world (`new_group`), so the
        first call makes every group of the axis's partition, in one
        order on every rank; the SPMD program reaches that call on every
        rank at the same point."""
        axs = tuple(axis) if isinstance(axis, tuple) else (axis,)
        key = (mesh.axis_names, mesh.shape, axs)
        got = self.groups.get(key)
        if got is None:
            parts = sorted({dataclasses.replace(mesh, rank=r).group(axs)
                            for r in range(self.world)},
                           key=lambda g: sorted(g))
            mine = mesh.group(axs)
            for ranks in parts:
                pg = torch.distributed.new_group(sorted(ranks))
                if ranks == mine:
                    got = AxisGroup(pg, mine)
            self.groups[key] = got
        return got

    def lib_call(self, fn, kind: str = "", nbytes: int = 0):
        """Run `fn()`, one library collective that waits on its work, and
        count it and its host time (`lib_calls`, `lib_s`); `kind` and
        `nbytes` (its output's bytes) are for a meta rank's tally."""
        t0 = time.perf_counter()
        fn()
        self.lib_s += time.perf_counter() - t0
        self.lib_calls += 1

    @property
    def is_meta(self) -> bool:
        return self.device.type == "meta"


# The collective kinds a meta rank tallies: the reference dry run's names
# for the ops it counts in the compiled HLO.
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


@dataclasses.dataclass
class MetaRank(RankContext):
    """One rank of `mesh` traced on the "meta" device (`meta_rank`).  Its
    heap is meta slots of `slot_bytes` (no storage), so a heap round
    (`netops.MetaNetOps`) is counted chunk by chunk as the rank's would
    be, with its DMA stores and reads on the kernels' meta paths; there is
    no barrier.  A library collective is not called but counted
    (`lib_calls`); each heap round counts as a "collective-permute" (the
    reference's shmem backend lowers its rounds to ppermutes) and each
    library call under its own kind, with its output's bytes, in
    `coll_bytes` and `coll_counts`."""
    coll_bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0))
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0))

    def barrier(self) -> None:
        pass

    def axis_group(self, mesh, axis) -> "AxisGroup":
        axs = tuple(axis) if isinstance(axis, tuple) else (axis,)
        return AxisGroup(None, mesh.group(axs))

    def lib_call(self, fn, kind: str = "", nbytes: int = 0):
        self.lib_calls += 1
        self.note(kind, nbytes)

    def note(self, kind: str, nbytes: int) -> None:
        """One collective of `kind` whose output has `nbytes`."""
        self.coll_bytes[kind] += int(nbytes)
        self.coll_counts[kind] += 1


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """A mesh axis's torch.distributed group seen from one rank.
    `ranks` are its world ranks in PE order (entry i has PE id i on the
    axis); torch numbers a group's members by ascending world rank, so
    `order[g]` is the PE id of group rank g and `index[i]` the group rank
    of PE i.  For a tuple axis whose flattened order is not ascending
    world rank (("model", "data") of a data x model mesh) the two differ,
    and a gather's blocks and an exchange's routes are mapped through
    them."""
    pg: object
    ranks: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def order(self) -> list[int]:
        return sorted(range(self.size), key=lambda i: self.ranks[i])

    @property
    def index(self) -> list[int]:
        srt = sorted(self.ranks)
        return [srt.index(r) for r in self.ranks]

    @property
    def in_order(self) -> bool:
        """Whether group rank and PE id agree."""
        return list(self.ranks) == sorted(self.ranks)


_CURRENT: RankContext | None = None


def current() -> RankContext:
    """This rank process's context; raises outside `run`."""
    if _CURRENT is None:
        raise RuntimeError("no SPMD rank runtime: this runs inside a rank "
                           "process started by repro_torch.core.spmd.run")
    return _CURRENT


def active() -> bool:
    """Whether this process is a rank of `run` (or inside `meta_rank`)."""
    return _CURRENT is not None


@contextlib.contextmanager
def meta_rank(mesh, slot_bytes: int = SLOT_BYTES):
    """Run the body as rank `mesh.rank` of `mesh` (a `launch.mesh.
    RankMesh`) on the "meta" device: `active()` is true, `current()` is a
    `MetaRank` with the mesh and a heap of meta slots of `slot_bytes`
    (the card's default; `CPU_SLOT_BYTES` to count as CPU ranks do).
    Yields the context, whose counters the body's program advances."""
    global _CURRENT
    if _CURRENT is not None:
        raise RuntimeError("meta_rank inside a rank: one rank a process")
    heap = SymmetricHeap(torch.empty((mesh.size, 2, slot_bytes),
                                     dtype=torch.uint8, device="meta"))
    _CURRENT = MetaRank(mesh.rank, mesh.size, heap, torch.device("meta"),
                        mesh=mesh)
    try:
        yield _CURRENT
    finally:
        _CURRENT = None


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to_cpu(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _entry(rank, world, fn, args, buf, store_path, out_dir):
    """One rank process: rendezvous, run `fn`, save its result."""
    global _CURRENT
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    device = buf.device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:               # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    store = torch.distributed.FileStore(store_path, world)
    torch.distributed.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=timedelta(seconds=BARRIER_TIMEOUT_S))
    _CURRENT = RankContext(rank, world, SymmetricHeap(buf), device)
    try:
        out = fn(*args)
    finally:
        _CURRENT = None
    # a rank that raised leaves its peers blocked at a barrier, so that
    # its own error is the one `run` reports (and the peers are ended)
    torch.save(_to_cpu(out), os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def run(fn, n: int, *args, slot_bytes: int | None = None, device=None,
        heap: SymmetricHeap | None = None) -> list:
    """Run ``fn(*args)`` in `n` rank processes on `device` (the card
    unless the caller asks for the CPU) and return the list of their
    results, moved to the CPU.  `fn` must be importable by name (a
    module-level function).  The heap (`heap`, or a new one of `n` slots
    of `slot_bytes`, see `SymmetricHeap.allocate`) is held here until
    every rank has exited.  No process outlives the call: the ranks are
    joined, and the resource tracker that starting them launched (if
    none ran before) is stopped and reaped."""
    from multiprocessing import resource_tracker

    import torch.multiprocessing as mp

    if heap is None:
        heap = SymmetricHeap.allocate(n, slot_bytes, device)
    elif heap.n_pes != n:
        raise ValueError(f"a heap of {heap.n_pes} PEs for {n} ranks")
    # a spawn-context process start launches multiprocessing's resource
    # tracker, a child that would run on past this process's exit
    tracker = resource_tracker._resource_tracker
    own_tracker = tracker._pid is None
    tmp = tempfile.mkdtemp(prefix="repro_spmd_")
    try:
        mp.spawn(_entry, args=(n, fn, args, heap.buf,
                               os.path.join(tmp, "store"), tmp),
                 nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if own_tracker:
            tracker._stop()
