"""Step assembly on the rank mesh (port of `repro/launch/build.py` for
training and serving): from (arch config, mesh dims, comm knobs) to the
functions a rank process runs, and the shapes and specs of the
parameters and decode caches.

The reference's `shard_mapped` wraps a function in shard_map; here it
runs the function in every rank process of `core.spmd.run`, each on its
own local shards, and returns every rank's result.  A mesh argument is a
`launch.mesh.RankMesh` (in the parent, `mesh_of(data, model, pod)` gives
one seen from rank 0: only its axis names and sizes are read).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import spmd
from ..models import transformer
from ..models.config import SHAPES, ModelConfig
from ..parallel import sharding
from ..parallel.comm import AxisSpec
from ..serve import step as sstep
from ..train import optimizer as opt
from ..train import step as tstep
from .mesh import RankMesh, make_mesh


def mesh_of(data: int, model: int, pod: int | None = None) -> RankMesh:
    """The (pod,) data x model mesh seen from rank 0, for shapes and
    specs outside the rank processes."""
    if pod:
        return RankMesh(("pod", "data", "model"), (pod, data, model), 0)
    return RankMesh(("data", "model"), (data, model), 0)


def mesh_dims(mesh) -> tuple[int, int, int | None]:
    d = mesh.sizes
    return d["data"], d["model"], d.get("pod")


def axis_spec(mesh, cfg=None) -> AxisSpec:
    pod = "pod" if "pod" in mesh.axis_names else None
    if cfg is not None and cfg.shard_strategy == "dp_only":
        return AxisSpec(model=None, pod=pod)
    return AxisSpec(pod=pod)


def mesh_axes(mesh, cfg=None) -> sharding.MeshAxes:
    pod = "pod" if "pod" in mesh.axis_names else None
    if cfg is not None and cfg.shard_strategy == "dp_only":
        return sharding.MeshAxes(model=None, pod=pod)
    return sharding.MeshAxes(pod=pod)


def eff_tp(cfg: ModelConfig, mesh) -> int:
    return 1 if cfg.shard_strategy == "dp_only" else mesh_dims(mesh)[1]


def abstract_params(cfg: ModelConfig, mesh):
    """(local shapes: a tree of meta tensors, specs) of one rank; with
    cfg.fsdp the fsdp leaves hold 1/dp of their rows."""
    dp, _, _ = mesh_dims(mesh)
    tp = eff_tp(cfg, mesh)
    shapes = transformer.init_params(cfg, device="meta", tp=tp, dp=dp)
    shapes = sharding.fsdp_localize(cfg, shapes, dp)
    return shapes, sharding.param_specs(cfg, shapes, mesh_axes(mesh, cfg),
                                        tp)


def global_shape(local_shape_tree, spec_tree, mesh):
    """Local leaves (tensors or meta tensors) -> their global shapes, per
    the specs."""
    sizes = mesh.sizes

    def one(leaf, spec):
        shape = list(leaf.shape)
        for i, ax in enumerate(spec):
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                shape[i] *= sizes[a]
        return torch.Size(shape)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, sv) for v, sv in zip(t, s)]
        return one(t, s)

    return walk(local_shape_tree, spec_tree)


def _in_mesh(fn, dims, per_rank_args):
    """A rank's body: make the mesh, move its arguments to its device,
    run `fn`."""
    rt = spmd.current()
    make_mesh(*dims)
    args = () if per_rank_args is None else per_rank_args[rt.rank]

    def to_dev(x):
        if isinstance(x, torch.Tensor):
            return x.to(rt.device)
        if isinstance(x, dict):
            return {k: to_dev(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_dev(v) for v in x)
        return x

    return fn(*to_dev(args))


def shard_mapped(fn, dims: tuple[int, ...], per_rank_args=None, *,
                 device=None, slot_bytes: int | None = None) -> list:
    """Run ``fn(*per_rank_args[r])`` in rank r of a (pod,) data x model
    mesh of rank processes (`dims`: `make_mesh`'s (data, model) or
    (data, model, pod)) on `device` (the card unless the caller asks
    for the CPU), each holding its own local shards; returns every rank's
    result (rank 0's first).  `fn` must be a module-level function."""
    n = math.prod(dims)
    if per_rank_args is not None and len(per_rank_args) != n:
        raise ValueError(f"{len(per_rank_args)} argument sets for {n} ranks")
    return spmd.run(_in_mesh, n, fn, tuple(dims), per_rank_args,
                    device=device, slot_bytes=slot_bytes)


def make_init_fn(cfg: ModelConfig, mesh, backend: str = "shmem"):
    """(init, shapes, specs): ``init(seed, device)`` in a rank gives its
    local shards; every rank draws from the same seed, so replicated
    leaves are identical everywhere.  With cfg.fsdp each fsdp leaf is
    drawn whole (model-local, data-full) and cut to the rank's rows
    (`sharding.fsdp_shard_init`), as the reference's init.  The init
    runs no collective: `backend` is taken, as the reference's, and
    changes nothing."""
    dp, _, _ = mesh_dims(mesh)
    tp = eff_tp(cfg, mesh)
    shapes, specs = abstract_params(cfg, mesh)

    def init(seed: int = 0, device=None):
        p = transformer.init_params(cfg, seed=seed, device=device, tp=tp,
                                    dp=dp)
        if cfg.fsdp:
            m = spmd.current().mesh if spmd.active() else mesh
            p = sharding.fsdp_shard_init(cfg, p, m.coords["data"], dp)
        return p

    return init, shapes, specs


def local_batch(cfg: ModelConfig, batch: dict, mesh, kind: str = "train",
                seq_shards: int = 1) -> dict:
    """This rank's slice of a GLOBAL batch, per `sharding.batch_specs`
    (with `seq_shards` > 1 the whole batch: it is replicated)."""
    specs = sharding.batch_specs(cfg, batch, mesh_axes(mesh, cfg), kind,
                                 seq_shards)
    out = {}
    for k, v in batch.items():
        for dim, ax in enumerate(specs[k]):
            if ax is None:
                continue
            axs = ax if isinstance(ax, tuple) else (ax,)
            n, i = mesh.axis_size(axs), mesh.axis_index(axs)
            size = v.shape[dim] // n
            v = v[(slice(None),) * dim + (slice(i * size, (i + 1) * size),)]
        out[k] = v
    return out


def make_train_step(cfg: ModelConfig, mesh, backend: str = "shmem",
                    fuse_grads: bool = True, allreduce_algo: str = "paper",
                    grad_rs: bool | str = False, pipeline_chunks=None,
                    topo=None, link=None, embedding=None, autotune=None,
                    profile=None, adamw: opt.AdamWConfig | None = None,
                    donate: bool = False):
    """(step, (shapes, pspecs), ocfg): ``step(params, opt_state,
    global_batch)`` runs in a rank on its local shards and its slice of
    the global batch (numpy or tensors) -> (loss, params, opt_state);
    with `donate` it updates the trees it is given in place
    (`train/step.build_train_step`)."""
    shapes, pspecs = abstract_params(cfg, mesh)
    ocfg = adamw or opt.AdamWConfig(moment_dtype=cfg.moment_dtype)
    inner = tstep.build_train_step(
        cfg, axis_spec(mesh, cfg), backend, adamw=ocfg,
        fuse_grads=fuse_grads, allreduce_algo=allreduce_algo,
        grad_rs=grad_rs, pipeline_chunks=pipeline_chunks, topo=topo,
        link=link, embedding=embedding, autotune=autotune, profile=profile,
        donate=donate)

    def step(params, opt_state, batch):
        m = spmd.current().mesh if spmd.active() else mesh
        return inner(params, opt_state, local_batch(cfg, batch, m))

    return step, (shapes, pspecs), ocfg


def make_serve_steps(cfg: ModelConfig, mesh, shape_name: str,
                     backend: str = "shmem"):
    """(prefill, decode, (cache_shapes, cache_specs), (shapes, pspecs),
    seq_shards) for the shape cell `shape_name` of `SHAPES` on `mesh`,
    as the reference's (serving never runs fsdp).  ``prefill(params,
    batch)`` and ``decode(params, cache, batch)`` run in a rank on its
    local shards and its slice of the GLOBAL batch (numpy or tensors,
    the batch over (pod, data), pod-major): the last-position logits
    (B_local, 1, V_local), and with the cache (the rank's `init_cache` at
    the cell's length, its specs `sharding.cache_specs`: the batch over
    `data` alone, as the reference's) the decode step's.  `cache_shapes`
    are meta tensors (None for a prefill cell).  A decode cell whose
    batch is below the data size dp x pod (the reference's long_500k)
    shards its cache's sequence over `data`: seq_shards = dp (not dp x
    pod: the reference's count, mirrored), every rank holds the whole
    batch and cache_len / dp slots of it."""
    cfg = dataclasses.replace(cfg, fsdp=False)
    dp, tp, pod = mesh_dims(mesh)
    axes = axis_spec(mesh)
    shapes, pspecs = abstract_params(cfg, mesh)
    s = SHAPES[shape_name]
    B, Lc = s["global_batch"], s["seq_len"]
    data_total = dp * (pod or 1)
    seq_shards = 1
    if s["kind"] == "decode" and B < data_total:
        # tiny-batch long-context: shard the cache sequence over data
        seq_shards = dp
    batch_local = B // data_total if seq_shards == 1 else B
    if s["kind"] == "decode":
        cache_shapes = transformer.init_cache(cfg, tp, batch_local, Lc,
                                              seq_shards, device="meta")
        cspecs = sharding.cache_specs(cfg, cache_shapes, mesh_axes(mesh),
                                      seq_shards)
    else:               # prefill / encoder forward: no decode cache exists
        cache_shapes, cspecs = None, None
    prefill_fn = sstep.build_prefill(cfg, axes, backend)
    decode_fn = sstep.build_decode_step(cfg, axes, backend, seq_shards)

    def local(params, batch, kind, shards=1):
        """The rank's slice, on its parameters' device, ids as int64."""
        m = spmd.current().mesh if spmd.active() else mesh
        dev = params["final_norm"].device
        out = {}
        for k, v in local_batch(cfg, batch, m, kind, shards).items():
            v = torch.as_tensor(v, device=dev)
            out[k] = v if v.is_floating_point() else v.long()
        return out

    def prefill(params, batch):
        return prefill_fn(params, local(params, batch, "prefill"))

    def decode(params, cache, batch):
        return decode_fn(params, cache, local(params, batch, "decode",
                                              seq_shards))

    return prefill, decode, (cache_shapes, cspecs), (shapes, pspecs), \
        seq_shards
