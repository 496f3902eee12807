"""Multi-pod dry run: trace one rank's step of every (arch x shape x mesh
x comm) cell on the meta device (port of `repro/launch/dryrun.py`).

Proves the distribution config holds together without hardware, as the
reference's does: the step of every cell must trace on rank 0 of the
16x16 production mesh AND of the 2x16x16 multi-pod mesh
(`launch.mesh.make_production_mesh`), and its readings say whether the
working set fits a card and where the step's time would go.

The reference lowers and compiles each step on 256 or 512 forced host
devices and reads XLA's analyses.  The port has no compiler to ask: it
runs rank 0's step under `core.spmd.meta_rank` on PyTorch's "meta"
device (shapes and dtypes, no storage), with the rank's own parameters,
optimizer state, batch slice and decode cache as meta tensors
(`build.abstract_params`, `opt.init_state`, `build.local_batch`,
`make_serve_steps`' cache shapes), under a `TorchDispatchMode` that sees
every aten op.  The kernels take their meta paths (`kernels/_meta.py`).
What stands in for the reference's readings:

  lower_s, compile_s  ->  trace_s, the wall of the trace.
  memory_analysis()   ->  memory: argument_bytes (the rank's parameters,
      optimizer state and batch slice, and the cache of a decode cell),
      output_bytes, alias_bytes (what the reference donates: parameters
      and optimizer state of a train cell, the cache of a decode cell),
      peak_bytes (the largest sum of live storages during the step, each
      storage counted once, whatever views it has; autograd's saved
      tensors stay alive as on the card; the rank's two heap slots
      included) and temp_bytes (peak less the arguments).
  cost_analysis()     ->  roofline.hlo_flops: `torch.utils.flop_counter`'s
      formulas over the dispatched ops, plus the kernels' operations;
      roofline.hlo_bytes: the input and output bytes of every dispatched
      op (views move none), plus the kernels' bytes.  Eager PyTorch runs
      each op as a kernel of its own, so to first order this sum is the
      step's HBM traffic.
  _collective_bytes() ->  collectives: it parses the compiled HLO and has
      no port; the collectives are counted where the rank issues them
      (`spmd.MetaRank`): under shmem each heap round as a
      "collective-permute" (the reference's shmem backend lowers its
      rounds to ppermutes), under xla each library call under its own
      kind, with its output's bytes.

A train step of more than `TRACED_MICROBATCHES` microbatches is traced
at 2 and at 3 of them and its counts extrapolated (`trace_step`): the
reference's compile traces its microbatch loop once; tracing deepseek-
v3's 16 eagerly, each MoE layer's two alltoalls 255 heap rounds over its
256-PE expert group, would take tens of minutes a cell.

Beside these, each cell records the counts a run on the card can be held
to: `heap_rounds`, `lib_calls` and `kernel_launches` by kernel.  The
roofline's times price the rank's work at the H100's rates (not the
reference's v5e constants): the dense bf16 (or f32) peak, 3.35e12 B/s of
HBM, and NVLink 4's 450e9 B/s a direction (900 GB/s both ways, NVIDIA's
H100 SXM datasheet).  They are predictions from shapes.

The dry run needs no card and never touches one.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multipod] [--comm shmem|xla]
Results land in experiments/pt_dryrun/<arch>__<shape>__<mesh>__<comm>.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..core import spmd
from ..core.heap import tree_flatten

# H100 SXM rates a card
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BW = 3.35e12            # B/s
LINK_BW = 450e9             # B/s, NVLink 4, one direction

_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "alias"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class StepTrace(TorchDispatchMode):
    """Watches every aten op of a traced step: the live storages and
    their peak, the bytes each op reads and writes, and its operations by
    `torch.utils.flop_counter`'s formulas (`flop_registry`, the ones
    `FlopCounterMode` applies).  A storage counts from its first
    appearance until its last tensor dies (`weakref.finalize` on the
    storage, so views do not count twice)."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, int] = {}
        self.cur = 0
        self.peak = 0
        self.op_bytes = 0
        self.flops = 0

    def hold(self, t: torch.Tensor, nbytes: int | None = None) -> None:
        """Count `t`'s storage as live (with `nbytes` in place of its
        size: a rank's slice of a global batch)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        nb = st.nbytes() if nbytes is None else int(nbytes)
        self.live[key] = nb
        self.cur += nb
        self.peak = max(self.peak, self.cur)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if not (func.is_view or
                func.overloadpacket.__name__ in _NO_TRAFFIC):
            self.op_bytes += sum(_nbytes(t) for t in
                                 _tensors((args, kwargs)) + outs)
        for t in outs:
            self.hold(t)
        return out


def roofline_terms(flops: float, nbytes: float, coll_bytes: float,
                   dtype) -> dict:
    return {
        "compute_s": flops / PEAK_FLOPS.get(dtype, PEAK_FLOPS[torch.float32]),
        "memory_s": nbytes / HBM_BW,
        "collective_s": coll_bytes / LINK_BW,
        "hlo_flops": flops,
        "hlo_bytes": nbytes,
        "collective_bytes": coll_bytes,
    }


def _launch_counts() -> dict:
    from ..kernels import flash_attention, fused_update, put_copy
    from ..kernels import reduce_combine, ring_attention, ssd_scan
    return {"put_copy": put_copy.launches,
            "dma_copy": put_copy.dma_launches,
            "reduce_combine": reduce_combine.launches,
            "flash_attention": flash_attention.launches,
            "fused_update": fused_update.launches,
            "ring_attention": ring_attention.launches,
            "ssd_scan": ssd_scan.launches}


def _local_bytes(cfg, specs: dict, mesh, kind: str, seq_shards: int = 1):
    """The bytes of this rank's slice of the global batch `specs`."""
    from . import build
    local = build.local_batch(cfg, specs, mesh, kind, seq_shards)
    return sum(_nbytes(v) for v in local.values())


def _trace(cfg, kind: str, shape: str, mesh, comm: str, slot_bytes: int,
           specs: dict) -> dict:
    """One trace of the rank's step on the meta device: its additive
    counts ("add") and its memory."""
    from ..kernels import _meta
    from ..train import optimizer as opt
    from . import build

    before = _launch_counts()
    _meta.reset()
    t0 = time.time()
    with spmd.meta_rank(mesh, slot_bytes) as rt:
        trace = StepTrace()
        if kind == "train":
            step, (params, _), ocfg = build.make_train_step(
                cfg, mesh, comm, donate=True)
            ostate = opt.init_state(params, ocfg, cfg.local_global_period)
            batch_bytes = _local_bytes(cfg, specs, mesh, "train")
            donated = args = (params, ostate)
            run = lambda: step(params, ostate, specs)  # noqa: E731
        else:
            prefill, decode, (cache, _), (params, _), seq_shards = \
                build.make_serve_steps(cfg, mesh, shape, comm)
            batch_bytes = _local_bytes(cfg, specs, mesh, kind, seq_shards)
            if kind == "decode":
                donated, args = cache, (params, cache)
                run = lambda: decode(params, cache, specs)  # noqa: E731
            else:
                donated, args = (), (params,)
                run = lambda: prefill(params, specs)  # noqa: E731
        for t in _tensors(args):
            trace.hold(t)
        # the meta heap holds every rank's slots; a rank of a production
        # mesh holds its own two
        trace.hold(rt.heap.buf, 2 * rt.heap.slot_bytes)
        for t in _tensors(specs):       # the rank's slice counts, below
            trace.hold(t, 0)
        trace.cur += batch_bytes
        trace.peak = max(trace.peak, trace.cur)
        with trace:
            out = run()
        out_bytes = _storage_bytes(out)
    after = _launch_counts()
    add = {"flops": trace.flops, "op_bytes": trace.op_bytes,
           "heap_rounds": rt.rounds, "lib_calls": rt.lib_calls,
           "coll_bytes": dict(rt.coll_bytes),
           "coll_counts": dict(rt.coll_counts),
           "launches": {k: after[k] - before[k] for k in after},
           "kern_ops": sum(w["ops"] for w in _meta.work.values()),
           "kern_bytes": sum(w["bytes"] for w in _meta.work.values())}
    return {"add": add, "trace_s": time.time() - t0,
            "state_bytes": _storage_bytes(args),
            "alias_bytes": _storage_bytes(donated),
            "batch_bytes": batch_bytes, "output_bytes": out_bytes,
            "peak_bytes": trace.peak}


def _affine(a, b, k: int):
    """a + k (b - a), leaf by leaf of nested dicts of numbers."""
    if isinstance(a, dict):
        return {key: _affine(a[key], b[key], k) for key in a}
    return a + k * (b - a)


# A train step of more microbatches than this is traced at 2 and at 3
# microbatches of its own size and its counts extrapolated (`trace_step`)
TRACED_MICROBATCHES = 3


def trace_step(cfg, shape: str, mesh, comm: str = "shmem",
               slot_bytes: int = spmd.SLOT_BYTES, batch: dict | None = None
               ) -> dict:
    """Trace rank `mesh.rank`'s step of the cell (cfg, `shape`) on
    `mesh` under `comm` on the meta device, with `slot_bytes` heap slots
    (the card's by default); `batch` replaces `input_specs`' global batch
    (meta tensors).  Returns the readings (the cell JSON's `memory`,
    `roofline`, `collectives` and counts).

    A train step of mb > TRACED_MICROBATCHES microbatches (after the
    step's clamp to the rank's batch) is traced at 2 and at 3
    microbatches of the same size, and every count (operations, bytes,
    heap rounds, library calls, collectives, launches) extrapolated to mb
    on the line through the two: each microbatch after the first repeats
    the same work (mb = 1 takes another path), and the accumulation,
    the sync and the optimizer step come once.  Its peak is the
    3-microbatch trace's, the batch counted at its real size (the rank's
    int32 slice and the step's int64 copy of it)."""
    from ..models.config import SHAPES, input_specs
    from ..train.step import microbatches_of
    from . import build

    kind = SHAPES[shape]["kind"]
    specs = batch if batch is not None else input_specs(cfg, shape)
    mb = 1
    if kind == "train":
        b_local = next(iter(build.local_batch(cfg, specs, mesh).values())
                       ).shape[0]
        mb = microbatches_of(cfg, b_local)
    if mb <= TRACED_MICROBATCHES:
        got = _trace(cfg, kind, shape, mesh, comm, slot_bytes, specs)
        add, trace_s = got["add"], got["trace_s"]
        batch_bytes = got["batch_bytes"]
        peak = got["peak_bytes"]
    else:
        per = b_local // mb
        rows = next(iter(specs.values())).shape[0] // b_local

        def at(m):
            cut = {k: torch.empty((m * per * rows,) + tuple(v.shape[1:]),
                                  dtype=v.dtype, device="meta")
                   for k, v in specs.items()}
            return _trace(dataclasses.replace(cfg, microbatches=m), kind,
                          shape, mesh, comm, slot_bytes, cut)

        two, got = at(2), at(3)
        add = _affine(two["add"], got["add"], mb - 2)
        trace_s = two["trace_s"] + got["trace_s"]
        batch_bytes = _local_bytes(cfg, specs, mesh, "train")
        peak = got["peak_bytes"] + 3 * (batch_bytes - got["batch_bytes"])
    arg_bytes = got["state_bytes"] + batch_bytes
    coll = {"bytes": add["coll_bytes"], "counts": add["coll_counts"]}
    terms = roofline_terms(float(add["flops"] + add["kern_ops"]),
                           float(add["op_bytes"] + add["kern_bytes"]),
                           float(sum(coll["bytes"].values())), cfg.dtype)
    return {
        "trace_s": round(trace_s, 1),
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": got["output_bytes"],
                   "alias_bytes": got["alias_bytes"],
                   "temp_bytes": peak - arg_bytes, "peak_bytes": peak},
        "roofline": terms,
        "collectives": coll,
        "heap_rounds": add["heap_rounds"],
        "lib_calls": add["lib_calls"],
        "kernel_launches": {k: v for k, v in add["launches"].items() if v},
    }


def run_cell(arch: str, shape: str, multipod: bool, comm: str,
             outdir: pathlib.Path, verbose: bool = True) -> dict:
    from ..configs import get_config
    from ..models.config import shape_applicable
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    cell = f"{arch}__{shape}__{'2x16x16' if multipod else '16x16'}__{comm}"
    if not ok:
        res = {"cell": cell, "status": "skipped", "reason": why}
        _write(outdir, cell, res)
        if verbose:
            print(f"[dryrun] {cell}: SKIPPED ({why})")
        return res

    mesh = make_production_mesh(multi_pod=multipod)
    got = trace_step(cfg, shape, mesh, comm)
    res = {"cell": cell, "status": "ok", "n_chips": mesh.size, **got}
    _write(outdir, cell, res)
    if verbose:
        terms = res["roofline"]
        print(f"[dryrun] {cell}: OK  trace={res['trace_s']:.0f}s  "
              f"FLOPs={terms['hlo_flops']:.3e}  "
              f"collB={terms['collective_bytes']:.3e}  "
              f"peak={res['memory']['peak_bytes']}")
        print(f"  memory: {res['memory']}")
    return res


def _write(outdir: pathlib.Path, cell: str, res: dict):
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / f"{cell}.json").write_text(json.dumps(res, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--comm", default="shmem", choices=["shmem", "xla"])
    ap.add_argument("--outdir", default="experiments/pt_dryrun")
    args = ap.parse_args(argv)
    outdir = pathlib.Path(args.outdir)

    from ..configs import ARCHS
    from ..models.config import SHAPES
    cells = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    failures = []
    for a, s in cells:
        try:
            run_cell(a, s, args.multipod, args.comm, outdir)
        except Exception as e:  # noqa
            print(f"[dryrun] {a}__{s}: FAILED {type(e).__name__}: {e}")
            failures.append((a, s, str(e)))
    if failures:
        print(f"{len(failures)} cells failed"); sys.exit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
