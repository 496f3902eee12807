"""The fusion layer: schedule stages interleaved with kernel execution
(port of `repro/core/fusion.py`, DESIGN.md §14), on the SIM backend.

ring_attention
    Sequence-sharded attention.  Each ring step's KV-block rotation is a
    CommPattern issued via `put_nbi` on a DEDICATED context (its own
    pending-op queue, so unrelated traffic cannot drain it) before the
    flash partials of the block that arrived in the previous step are
    computed (kernel 6, kernels/ring_attention.py: one launch per step
    for all PEs).  `fence()` orders the puts per ring neighbour;
    `quiet(fk, fv, fp)` completes exactly this step's rotation before the
    next step consumes it: the double-buffer slot protocol.  On the card
    the rotation's put_copy launches and kernel 6 share one stream, so
    they run in issue order and do not overlap (a side stream is later
    perf work).

fused_rs_adam
    Ring reduce-scatter whose FINAL combine lands inside the k-ary
    combine + AdamW kernel (kernels/fused_update.py): the fully reduced
    gradient chunk is consumed by the optimizer in the same kernel pass
    and the full gradient is never materialised.  Only the updated PARAM
    chunk is allgathered, at the param dtype, so against the unfused
    reduce-scatter + f32 allgather the wire bytes drop from 2B to
    B * (1 + itemsize/4).

choose_attention / choose_grad_rs price the fused variants against the
monolithic ones (abmodel.modeled_overlapped_time, the schedules' alpha-beta
times); a measured tuner verdict (`tuner=`, core/tuner.py) wins over the
model.  The SPMD backend is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from . import abmodel
from . import collectives as coll
from . import netops
from .collectives import allgather_schedule, reduce_scatter_schedule
from .netops import NetOps, SimNetOps, device_table
from .pattern import ring_pattern
from ..kernels import ops
from ..kernels import ring_attention as _ra

_SLICE5 = "only the SIM backend is ported (the SPMD backend comes with " \
    "slice 5)"


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def ring_attention(ctx, q, k, v, q_pos, k_pos, *, causal: bool = True,
                   window: int | None = None, softcap: float | None = None,
                   sm_scale: float | None = None, out_dtype=None):
    """Sequence-sharded attention over `ctx`'s PEs (a SIM context).

    Each PE holds its query shard q (n, B, Hq, Lq_shard, D) with global
    positions q_pos (n, Lq_shard), and its KV shard k/v (n, B, Hkv,
    Lk_shard, D) with global positions k_pos (n, Lk_shard; -1 marks a
    padded slot), all stacked on the leading PE axis.  The KV shard walks
    the ring: at each step the NEXT block is issued with put_nbi on a
    private context, then the partials of the CURRENT block are computed,
    then quiet() completes the rotation.  The output (n, B, Hq, Lq_shard,
    D) in `out_dtype` (default q's) matches monolithic flash attention
    over the gathered sequence to f32 allclose: identical per-block
    arithmetic, with a per-PE merge order that the online softmax absorbs
    up to rounding."""
    net = ctx.net
    if not isinstance(net, SimNetOps):
        raise NotImplementedError(_SLICE5)
    n = net.n_pes
    kw = dict(causal=causal, window=window, softcap=softcap,
              sm_scale=sm_scale)

    def partials(k_, v_, kp_):
        return _ra.attn_block_partials(q, k_, v_, q_pos, kp_, **kw)

    out_dtype = q.dtype if out_dtype is None else out_dtype
    if n == 1:
        return _ra.finalize(partials(k, v, k_pos), out_dtype)

    c = ctx.ctx_create()                 # private queue: DESIGN.md §14
    ring = ring_pattern(n)               # PE i -> (i+1) % n, every step
    cur_k, cur_v, cur_kp = k, v, k_pos
    state = None
    for s in range(n):
        last = s == n - 1
        if not last:
            # issue the rotation BEFORE computing on the current block
            fk = c.put_nbi(cur_k, ring)
            fv = c.put_nbi(cur_v, ring)
            fp = c.put_nbi(cur_kp, ring)
            c.fence()                    # per-neighbour ordering of k/v/pos
        part = partials(cur_k, cur_v, cur_kp)
        state = part if state is None else _ra.merge_partials(state, part)
        if not last:
            # double-buffer swap: completion of THIS step's rotation is
            # the next step's front buffer
            cur_k, cur_v, cur_kp = c.quiet(fk, fv, fp)
    return _ra.finalize(state, out_dtype)


# ---------------------------------------------------------------------------
# fused reduce-scatter -> AdamW update
# ---------------------------------------------------------------------------


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
    AdamW on f32 moments.  With `profile`, the innermost open op notes
    the "fused_rs_adam" selection and its reduce-scatter schedule."""
    if not isinstance(net, SimNetOps):
        raise NotImplementedError(_SLICE5)
    out_dtype = p_buf.dtype if out_dtype is None else out_dtype
    local, incoming, info, mask = coll._reduce_scatter_parts(
        net, g_buf, coll.OPS["sum"], team=team)
    _, size, chunk, own_idx = info
    if profile is not None:
        nbytes = coll._payload_bytes(net, g_buf)
        profile.note(algorithm="fused_rs_adam",
                     schedule=reduce_scatter_schedule(net.n_pes, nbytes),
                     collective="grad_sync", nbytes=nbytes,
                     n_pes=net.n_pes)
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


# ---------------------------------------------------------------------------
# pricing: the fused variants as selectable algorithms
# ---------------------------------------------------------------------------

def choose_attention(n: int, kv_block_bytes: float, block_compute_s: float,
                     *, topo=None, link=None, tuner=None
                     ) -> tuple[str, dict]:
    """"ring" vs "mono" for sequence-sharded attention over n PEs.

    kv_block_bytes: bytes of ONE PE's K+V(+pos) shard, what each ring
    step moves; block_compute_s: the flash time of q against one block.
    Mono allgathers the KV sequence first and computes monolithically;
    ring overlaps each rotation with one block's compute
    (abmodel.modeled_overlapped_time).  A measured-best tuner verdict
    for collective "attention" wins over the analytic model."""
    if n <= 1:
        return "mono", {"ring": 0.0, "mono": 0.0}
    total = kv_block_bytes * n
    sched = allgather_schedule(n, total)
    t_ring = abmodel.modeled_overlapped_time(
        sched.cost(topo), block_compute_s,
        link if link is not None else abmodel.ICI_V5E)
    t_mono = sched.time(topo, link) + n * block_compute_s
    times = {"ring": t_ring, "mono": t_mono}
    if tuner is not None:
        got = tuner.algorithm("attention", n, total, topo=topo,
                              candidates=("ring", "mono"))
        if got in times:
            return got, times
    return ("ring" if t_ring <= t_mono else "mono"), times


def choose_grad_rs(n: int, bucket_bytes: float, param_itemsize: int = 4,
                   *, topo=None, link=None, tuner=None) -> tuple[str, dict]:
    """"fused" vs "bucketed" for the gradient sync of one f32 bucket.

    Both price the same ring reduce-scatter; the fused path allgathers
    the updated PARAM chunk at `param_itemsize` instead of the f32
    gradient: strictly fewer wire bytes for sub-f32 params, equal for f32
    (where fusing still saves the separate optimizer pass, so ties go to
    "fused").  Tuner verdicts for collective "grad_sync" win."""
    if n <= 1:
        return "bucketed", {"fused": 0.0, "bucketed": 0.0}
    t_rs = reduce_scatter_schedule(n, bucket_bytes).time(topo, link)
    t_ag_f32 = allgather_schedule(n, bucket_bytes).time(topo, link)
    t_ag_out = allgather_schedule(
        n, bucket_bytes * param_itemsize / 4.0).time(topo, link)
    times = {"fused": t_rs + t_ag_out, "bucketed": t_rs + t_ag_f32}
    if tuner is not None:
        got = tuner.algorithm("grad_sync", n, bucket_bytes, topo=topo,
                              candidates=("fused", "bucketed"))
        if got in times:
            return got, times
    return ("fused" if times["fused"] <= times["bucketed"]
            else "bucketed"), times
