"""Train-step builder: microbatched gradient accumulation, heap-fused
gradient sync over the paper's collectives, AdamW update (port of
`repro/train/step.py`).  On one device the data axis has one PE; inside a
rank process of `core.spmd.run` (`launch/build.make_train_step`) the
step runs on the rank's local shards and its batch slice, and the sync
runs over the data axis's PEs.

Gradient synchronisation packs every data-replicated gradient leaf onto
flat symmetric-heap buckets (core/heap.py) before one collective per
bucket: the paper's small-message alpha amortisation applied to the
~300 gradient tensors.  With grad_rs="fused" the sync IS the optimizer
step: ring reduce-scatter whose last combine lands in the combine +
AdamW kernel (kernel 5), then an allgather of the updated params.

The step runs eagerly on the parameters' device; batches arrive as numpy
(or tensors) and move there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import heap
from ..core.heap import tree_flatten, tree_unflatten
from ..models import transformer
from ..models.config import ModelConfig
from ..parallel import sharding
from ..parallel.comm import AxisSpec, Comm
from . import optimizer as opt

BUCKET_BYTES = 64 * 1024 * 1024   # fusion bucket size (f32 elements)

# Above this much data-replicated gradient payload (f32 bytes),
# grad_rs="auto" switches the sync from one allreduce per bucket to the
# bucketed reduce-scatter + allgather (Comm.grad_sync_bucketed).
GRAD_RS_AUTO_BYTES = 8 * 1024 * 1024


def plan_fused_buckets(leaves, bucket_bytes: int = BUCKET_BYTES):
    """Greedy bucketing of param/grad leaves for the fused RS + Adam path:
    at most `bucket_bytes` of f32 per bucket, split also where the dtype
    changes (the fused allgather ships each bucket's UPDATED params at
    their own dtype).  Returns a list of leaf-index lists, deterministic,
    so the optimizer state's init and the step agree on the plan."""
    budget = bucket_bytes // 4
    buckets, cur, cur_n = [], [], 0
    for i, l in enumerate(leaves):
        if cur and (cur_n + l.numel() > budget
                    or l.dtype != leaves[cur[0]].dtype):
            buckets.append(cur)
            cur, cur_n = [], 0
        cur.append(i)
        cur_n += l.numel()
    if cur:
        buckets.append(cur)
    return buckets


def _wd_mask(spec, decays, device):
    """int8 weight-decay element mask over a packed bucket: 1 on the
    elements of a leaf AdamW decays (`opt.decay_flags`), 0 on the others
    and on the alignment gaps between leaves.  Built on `device` with
    one fill per decayed leaf (no host copy)."""
    mask = torch.zeros(spec.total, dtype=torch.int8, device=device)
    for decay, off, shape in zip(decays, spec.offsets, spec.shapes):
        if decay:
            mask[off:off + int(np.prod(shape))] = 1
    return mask


def init_fused_opt_state(params, n_data: int = 1,
                         bucket_bytes: int = BUCKET_BYTES):
    """Optimizer state for grad_rs="fused": per bucket, this PE's OWNED
    moment chunks, shape (ceil(bucket_total / n_data),), zero."""
    leaves, _ = tree_flatten(params)
    device = leaves[0].device
    state = []
    for idxs in plan_fused_buckets(leaves, bucket_bytes):
        spec = heap.plan_pack([leaves[i] for i in idxs], dtype=torch.float32)
        chunk = -(-spec.total // n_data)
        state.append({"m": torch.zeros(chunk, device=device),
                      "v": torch.zeros(chunk, device=device)})
    return {"fused": state,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def fused_adam_sync(comm: Comm, params, grads, opt_state,
                    adamw: opt.AdamWConfig, sync_mask, *,
                    bucket_bytes: int = BUCKET_BYTES):
    """The fused gradient sync + optimizer step: packs params and grads
    onto matching flat f32 buckets and runs Comm.grad_sync_fused_update.
    Replaces both fused_grad_sync and opt.apply_updates, bit for bit
    equal to that composition (f32 moments).  opt_state comes from
    init_fused_opt_state; every leaf must be data-replicated."""
    if adamw.moment_dtype != "f32":
        raise ValueError("grad_rs='fused' needs f32 moments (the kernel's "
                         "bitwise contract)")
    leaves_p, treedef = tree_flatten(params)
    leaves_g, _ = tree_flatten(grads)
    if not all(tree_flatten(sync_mask)[0]):
        raise ValueError("grad_rs='fused' needs every param data-replicated")
    decays = opt.decay_flags(params)
    step_c = opt_state["step"] + 1
    c1, c2 = opt.bias_corrections(adamw, step_c)
    buckets = plan_fused_buckets(leaves_p, bucket_bytes)
    g_bufs, p_bufs, wd_masks, out_dtypes, out_specs = [], [], [], [], []
    for idxs in buckets:
        pb = [leaves_p[i] for i in idxs]
        spec32 = heap.plan_pack(pb, dtype=torch.float32)
        g_bufs.append(heap.pack([leaves_g[i] for i in idxs], spec32))
        p_bufs.append(heap.pack(pb, spec32))
        wd_masks.append(_wd_mask(spec32, [decays[i] for i in idxs],
                                 pb[0].device))
        out_dtypes.append(pb[0].dtype)
        # same shapes -> same element offsets: the param-dtype spec the
        # updated bucket unpacks with
        out_specs.append(heap.plan_pack(pb, dtype=pb[0].dtype))
    outs, new_moments = comm.grad_sync_fused_update(
        g_bufs, p_bufs, opt_state["fused"], wd_masks, c1, c2,
        lr=adamw.lr, b1=adamw.b1, b2=adamw.b2, eps=adamw.eps,
        wd_coef=adamw.weight_decay, out_dtypes=out_dtypes, mean=True)
    new_leaves = list(leaves_p)
    for idxs, out, spec in zip(buckets, outs, out_specs):
        for i, val in zip(idxs, heap.unpack(out, spec)):
            new_leaves[i] = val
    return (tree_unflatten(treedef, new_leaves),
            {"fused": new_moments, "step": step_c})


def fused_grad_sync(comm: Comm, grads, sync_mask, *, fuse: bool = True,
                    bucket_bytes: int = BUCKET_BYTES):
    """Mean-reduce grads over the data axis.  sync_mask marks the leaves
    that are data-replicated; others pass through untouched.  With `fuse`
    the leaves are packed onto flat buckets of `bucket_bytes`: one
    collective per bucket (with comm.grad_rs, the bucketed reduce-scatter
    + allgather of all buckets) instead of one per tensor; on the xla
    backend one grad_sync per bucket, as the reference's."""
    if not comm.grad_rs and comm._scale() == 1:
        return grads        # one data PE: the mean is g / 1, bit for bit
    leaves, treedef = tree_flatten(grads)
    mask, _ = tree_flatten(sync_mask)
    to_sync = [l for l, m in zip(leaves, mask) if m]
    if not to_sync:
        return grads
    if fuse:
        budget = bucket_bytes // 4
        buckets, cur, cur_n = [], [], 0
        for l in to_sync:
            if cur and cur_n + l.numel() > budget:
                buckets.append(cur)
                cur, cur_n = [], 0
            cur.append(l)
            cur_n += l.numel()
        if cur:
            buckets.append(cur)
        specs = [heap.plan_pack(b, dtype=torch.float32) for b in buckets]
        bufs = [heap.pack(b, s) for b, s in zip(buckets, specs)]
        if comm.grad_rs and comm.backend == "shmem":
            outs = comm.grad_sync_bucketed(bufs, mean=True)
        else:
            outs = [comm.grad_sync(buf, mean=True) for buf in bufs]
        synced = []
        for out, s in zip(outs, specs):
            synced.extend(heap.unpack(out, s))
    else:
        synced = comm.grad_sync(to_sync, mean=True)
    synced = [s.to(l.dtype) for s, l in zip(synced, to_sync)]
    it = iter(synced)
    out = [next(it) if m else l for l, m in zip(leaves, mask)]
    return tree_unflatten(treedef, out)


def batch_to_device(batch: dict, device) -> dict:
    """The batch's arrays as tensors on `device`, integer ids as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


def loss_and_grads(comm: Comm, cfg: ModelConfig, params, batch: dict,
                   mb: int = 1):
    """(mean loss, gradient tree) of `batch` over `mb` microbatches: f32
    gradients accumulated from zeros in microbatch order, then loss and
    gradients divided by `mb`, as the reference's scan does."""
    leaves, treedef = tree_flatten(params)

    def value_and_grad(mbatch):
        req = [l.detach().requires_grad_() for l in leaves]
        with torch.enable_grad():
            loss = transformer.train_loss(
                comm, cfg, tree_unflatten(treedef, req), mbatch)
            # a leaf the loss does not read (the audio encoder's token
            # table) gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, req, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), list(grads)

    if mb == 1:
        loss, grads = value_and_grad(batch)
        return loss, tree_unflatten(treedef, grads)
    size = next(iter(batch.values())).shape[0] // mb
    loss = torch.zeros((), device=leaves[0].device)
    acc = [torch.zeros(l.shape, dtype=torch.float32, device=l.device)
           for l in leaves]
    for i in range(mb):
        l, g = value_and_grad({k: v[i * size:(i + 1) * size]
                               for k, v in batch.items()})
        for a, gi in zip(acc, g):
            a.add_(gi)
        loss = loss + l
        del g
    return loss / mb, tree_unflatten(treedef, [a.div_(mb) for a in acc])


def build_train_step(cfg: ModelConfig, axes: AxisSpec = AxisSpec(),
                     backend: str = "shmem",
                     adamw: opt.AdamWConfig | None = None,
                     fuse_grads: bool = True, allreduce_algo: str = "paper",
                     grad_rs: bool | str = False, pipeline_chunks=None,
                     topo=None, link=None, embedding=None, autotune=None,
                     profile=None, donate: bool = False):
    """Returns step(params, opt_state, batch) -> (loss, params, opt_state).

    grad_rs: True forces the bucketed reduce-scatter + allgather gradient
    sync, False one allreduce per bucket, "auto" switches it on above
    GRAD_RS_AUTO_BYTES of synced gradient, and "fused" fuses the sync
    into the optimizer (opt_state from init_fused_opt_state, f32
    moments; shmem only: on the xla backend "fused" syncs each bucket
    with one grad_sync and the optimizer runs apart, as the
    reference's).  allreduce_algo, pipeline_chunks, topo, link and embedding
    are the step `Comm`'s (see there); on a one-PE data axis every sync
    but the bucketed and fused forms is the identity, whatever they say.
    `autotune` (a core.tuner.Tuner or TunedSelector) and `profile` (a
    core.profile.Profiler) ride on the step's `Comm`, as the
    reference's.  With `donate` the step updates the `params` and
    `opt_state` it is given in place (f32 moments; see
    `opt.apply_updates`): the caller must own them and not read them
    again, as JAX's donated arguments."""
    adamw = adamw or opt.AdamWConfig(moment_dtype=cfg.moment_dtype)

    def step(params, opt_state, batch):
        leaves, _ = tree_flatten(params)
        batch = batch_to_device(batch, leaves[0].device)
        mask = sharding.needs_data_sync(cfg, params)
        rs = grad_rs
        if grad_rs == "auto":
            synced = sum(4 * l.numel() for l, m in
                         zip(leaves, tree_flatten(mask)[0]) if m)
            rs = synced >= GRAD_RS_AUTO_BYTES
        comm = Comm(axes, backend, allreduce_algo=allreduce_algo,
                    grad_rs=rs, topo=topo, link=link,
                    pipeline_chunks=pipeline_chunks, embedding=embedding,
                    tuner=autotune, profile=profile)
        # clamp grad accumulation to the local batch
        b_local = next(iter(batch.values())).shape[0]
        mb = max(1, min(cfg.microbatches, b_local))
        while b_local % mb:
            mb -= 1
        loss, grads = loss_and_grads(comm, cfg, params, batch, mb)
        for a in axes.grad_axes():
            loss = comm.allreduce(loss, a) / comm.axis_size(a)
        if rs == "fused" and backend == "shmem":
            new_params, new_state = fused_adam_sync(
                comm, params, grads, opt_state, adamw, mask)
            return loss, new_params, new_state
        grads = fused_grad_sync(comm, grads, mask, fuse=fuse_grads)
        new_params, new_state = opt.apply_updates(
            params, grads, opt_state, adamw, cfg.local_global_period,
            inplace=donate)
        return loss, new_params, new_state

    return step


def build_eval_loss(cfg: ModelConfig, axes: AxisSpec = AxisSpec(),
                    backend: str = "shmem"):
    def fn(params, batch):
        leaves, _ = tree_flatten(params)
        with torch.no_grad():
            return transformer.train_loss(
                Comm(axes, backend), cfg, params,
                batch_to_device(batch, leaves[0].device))
    return fn
