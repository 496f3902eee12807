"""The fusion layer: schedule stages interleaved with kernel execution
(port of the fused reduce-scatter -> AdamW half of `repro/core/fusion.py`).

fused_rs_adam
    Ring reduce-scatter whose FINAL combine lands inside the k-ary
    combine + AdamW kernel (kernels/fused_update.py): the fully reduced
    gradient chunk is consumed by the optimizer in the same kernel pass
    and the full gradient is never materialised.  Only the updated PARAM
    chunk is allgathered, at the param dtype, so against the unfused
    reduce-scatter + f32 allgather the wire bytes drop from 2B to
    B * (1 + itemsize/4).

choose_grad_rs prices the fused variant against the bucketed one.

Ring attention (kernel 6) and `choose_attention` come with slice 4; the
tuner and the profiler with slice 5 (their parameters raise).
"""
from __future__ import annotations

import numpy as np
import torch

from . import collectives as coll
from . import netops
from .collectives import allgather_schedule, reduce_scatter_schedule
from .netops import NetOps, SimNetOps, device_table
from ..kernels import ops


def fused_rs_adam(net: NetOps, g_buf, p_buf, m, v, wd_mask, c1, c2, *,
                  lr: float, b1: float, b2: float, eps: float,
                  wd_coef: float, scale: float = 1.0, out_dtype=None,
                  team=None, profile=None):
    """Ring reduce-scatter of the PE-stacked flat f32 gradient bucket
    `g_buf` (n_pes, size) with the final combine fused into the AdamW
    update of each PE's owned param chunk.  `p_buf` is the matching f32
    param bucket (replicated); `m`/`v` are each PE's OWNED moment chunks,
    (n_pes, ceil(size/n)): they never ride the ring.  `wd_mask` (size,)
    is nonzero where weight decay applies; c1/c2 are ``1 - beta**t``;
    `scale` the gradient-mean divisor.

    Returns ``(new_p_chunk, new_m, new_v, info)``: the updated owned
    param chunks (in `out_dtype`) and the reduce-scatter `info` handle,
    for ``coll.allgather_unpad(net, new_p_chunk, info, team=team)``.  The
    update of all PEs' chunks is ONE kernel launch (the reference vmaps
    it), bit for bit equal to reduce-scatter + allgather + the plain
    AdamW on f32 moments."""
    coll._no_service(profile)
    if not isinstance(net, SimNetOps):
        raise NotImplementedError("only the SIM backend is ported (the "
                                  "SPMD backend comes with slice 5)")
    out_dtype = p_buf.dtype if out_dtype is None else out_dtype
    local, incoming, info, mask = coll._reduce_scatter_parts(
        net, g_buf, coll.OPS["sum"], team=team)
    _, size, chunk, own_idx = info
    n = net.n_pes
    padded = chunk * n
    p_pad = coll._flatpad(p_buf, padded)
    wd_pad = torch.nn.functional.pad(wd_mask.reshape(-1).to(torch.int8),
                                     (0, padded - size))
    own = device_table(np.asarray(own_idx, np.int64), net.device)
    p_chunk = netops.dyn_slice_block(net, p_pad, own, chunk, axis=0)
    wd_chunk = netops.dyn_slice_block(net, wd_pad.expand(n, padded), own,
                                      chunk, axis=0)
    g_parts = [local] if incoming is None else [local, incoming]
    new_p, new_m, new_v = ops.fused_adam_update(
        g_parts, p_chunk, m, v, wd_chunk, c1, c2, lr=lr, b1=b1, b2=b2,
        eps=eps, wd_coef=wd_coef, scale=scale, out_dtype=out_dtype)
    new_p = coll._mask_out(net, mask, new_p, keep=p_chunk.to(out_dtype))
    return new_p, new_m, new_v, info


def choose_grad_rs(n: int, bucket_bytes: float, param_itemsize: int = 4,
                   *, topo=None, link=None, tuner=None) -> tuple[str, dict]:
    """"fused" vs "bucketed" for the gradient sync of one f32 bucket.

    Both price the same ring reduce-scatter; the fused path allgathers
    the updated PARAM chunk at `param_itemsize` instead of the f32
    gradient: strictly fewer wire bytes for sub-f32 params, equal for f32
    (where fusing still saves the separate optimizer pass, so ties go to
    "fused")."""
    coll._no_service(tuner=tuner)
    if n <= 1:
        return "bucketed", {"fused": 0.0, "bucketed": 0.0}
    t_rs = reduce_scatter_schedule(n, bucket_bytes).time(topo, link)
    t_ag_f32 = allgather_schedule(n, bucket_bytes).time(topo, link)
    t_ag_out = allgather_schedule(
        n, bucket_bytes * param_itemsize / 4.0).time(topo, link)
    times = {"fused": t_rs + t_ag_out, "bucketed": t_rs + t_ag_f32}
    return ("fused" if times["fused"] <= times["bucketed"]
            else "bucketed"), times
