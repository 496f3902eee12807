"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper and the ground truth the kernels are held to on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  sm_scale=None, lk_valid=None):
    """q: (B,Hq,Lq,D); k: (B,Hkv,Lk,D); v: (B,Hkv,Lk,Dv). Dense reference
    attention.

    Products of the input dtype accumulate in f32 (the inputs are upcast
    before each contraction, which is exact for bf16), the softmax runs in
    f32, and the probabilities are rounded to v's dtype before the second
    contraction — the arithmetic of `repro.kernels.ref.attention_ref`.
    f64 inputs run the same steps in f64 (an oracle for the f32 ones)."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    group = hq // hkv
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    lk_valid = lk if lk_valid is None else lk_valid
    acc = torch.promote_types(q.dtype, torch.float32)
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kk.to(acc)) * sm_scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = torch.arange(lq, device=q.device)[:, None]
    k_pos = torch.arange(lk, device=q.device)[None, :]
    mask = k_pos < lk_valid
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), vv.to(acc))
    return out.to(q.dtype)


def ring_partials_ref(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                      softcap=None, sm_scale=None):
    """Un-normalised flash partials (acc, m, l) of q against ONE KV block,
    masked by global positions (`repro.kernels.ring_attention.
    _partials_ref`, with the SIM's leading PE axis).

    q: (P, B, Hq, Lq, D); k, v: (P, B, Hkv, Lk, D); q_pos: (P, Lq) and
    k_pos: (P, Lk) int32 (-1 marks a padded key slot, always masked).
    The unstacked shapes (no P axis) are accepted too.  Returns acc
    (..., Hq, Lq, D), m and l (..., Hq, Lq), all f32.  Masked logits are
    -1e30, so a row whose keys are all masked gets m = -1e30, l = Lk and
    acc = the sum of v over the block; `merge_partials` wipes such a
    partial with a weight exp(-1e30 - m) = 0."""
    if q.dim() == 4:
        acc, m, l = ring_partials_ref(
            q[None], k[None], v[None], q_pos[None], k_pos[None],
            causal=causal, window=window, softcap=softcap, sm_scale=sm_scale)
        return acc[0], m[0], l[0]
    group = q.shape[2] // k.shape[2]
    sm_scale = sm_scale if sm_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    logits = torch.einsum("pbhqd,pbhkd->pbhqk", q.float() * sm_scale,
                          k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("pbhqk,pbhkd->pbhqd", p, v.float())
    return acc, m, l


def mq_attention_ref(q, ck, cv, valid, *, softcap=None, q2slot=None,
                     allreduce=None):
    """Multi-query attention against a gathered cache, in f32 (the
    reference's `_attend_mq`): q (B, L, Hq, hd); ck, cv (B, S, K, hd);
    valid (B, L, S) -> (B, L, Hq, hd) f32.

    Grouped GQA (Hq = K x group), or with `q2slot` (Hq,) the
    replicated-KV plan: q head j reads stored head q2slot[j].  The
    reference contracts each q head against all K stored heads and then
    selects its slot by a one-hot (Hq, K) map in f32; gathering each q
    head's slot first (`index_select`) gives the same products, since a
    one-hot contraction adds exact zeros.  Every op is per row, so a
    row's result does not depend on the other rows of the batch.
    `allreduce(t, op)`, where given, combines over the shards of a cache
    whose sequence is split: the max of the logits before the
    exponentials, then the denominators and the weighted sums of v."""
    if q2slot is not None:
        ck, cv = ck.index_select(2, q2slot), cv.index_select(2, q2slot)
    B, S, K = ck.shape[0], ck.shape[1], ck.shape[2]
    L, hq, hd = q.shape[1], q.shape[2], q.shape[3]
    group = hq // K
    qf = q.float() / math.sqrt(hd)
    kf, vf = ck.float(), cv.float()
    qg = qf.reshape(B, L, K, group, hd)
    logits = torch.einsum("blkgd,bskd->blkgs", qg, kf).reshape(B, L, hq, S)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(valid[:, :, None, :], logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    if allreduce is not None:
        m = allreduce(m, "max")
    p_ = torch.exp(logits - m)
    l_den = p_.sum(-1, keepdim=True)
    pg = p_.reshape(B, L, K, group, S)
    acc = torch.einsum("blkgs,bskd->blkgd", pg, vf).reshape(B, L, hq, hd)
    if allreduce is not None:
        l_den = allreduce(l_den, "sum")
        acc = allreduce(acc, "sum")
    return acc / l_den.clamp_min(1e-30)


def paged_kv_gather(pool_leaf, page_table):
    """Gather a sequence-contiguous (B, S_max, ...) copy of each row's
    pages (S_max = max_pages * page_size).  Unassigned entries point at
    the null page; the attention mask excludes them."""
    got = pool_leaf[page_table]                     # (B, P, ps, ...)
    B, P, ps = got.shape[0], got.shape[1], got.shape[2]
    return got.reshape((B, P * ps) + tuple(got.shape[3:]))


def paged_decode_ref(q, pool_k, pool_v, page_table, positions, *,
                     page_size, window=None, softcap=None, q2slot=None):
    """One decode token a row against a paged KV pool, the plain way: every
    row's pages gathered sequence-contiguous out to max_pages x page_size
    (`paged_kv_gather`), then `mq_attention_ref` with the positions
    [pos - window + 1, pos] valid.  q (B, Hq, hd); pools (num_pages,
    page_size, K, hd); page_table (B, max_pages); positions (B,) ->
    (B, Hq, hd) f32."""
    ck = paged_kv_gather(pool_k, page_table)
    cv = paged_kv_gather(pool_v, page_table)
    kv_pos = torch.arange(ck.shape[1], device=q.device)[None, None, :]
    pos = positions[:, None, None]
    valid = kv_pos <= pos
    if window is not None:
        valid &= kv_pos > (pos - window)
    return mq_attention_ref(q[:, None], ck, cv, valid, softcap=softcap,
                            q2slot=q2slot)[:, 0]


def put_copy_ref(src, rows=None):
    """Output row i = ``src[rows[i]]``, zeros where ``rows[i]`` is -1;
    ``rows=None`` is the identity copy (`repro.kernels.ref.put_copy_ref`)."""
    if rows is None:
        return src.clone(memory_format=torch.contiguous_format)
    rows = rows.long()
    out = src[rows.clamp(min=0)]
    out[rows < 0] = 0
    return out


def dma_copy_ref(src, dst, descs):
    """Each descriptor ``(sr, sc, dr, dc, nr, nc)`` copies
    ``src[sr:sr+nr, sc:sc+nc]`` into ``dst[dr:dr+nr, dc:dc+nc]``, in order,
    IN PLACE; the rest of dst keeps its values.  Returns dst."""
    for sr, sc, dr, dc, nr, nc in descs.tolist():
        dst[dr:dr + nr, dc:dc + nc] = src[sr:sr + nr, sc:sc + nc]
    return dst


COMBINE_OPS = {"sum": torch.add, "prod": torch.mul,
               "max": torch.maximum, "min": torch.minimum}


def reduce_combine_ref(bufs, op: str = "sum"):
    """``op`` folded over `bufs` in order from ``bufs[0]``, each step in
    the storage dtype (`repro.kernels.ref.reduce_combine_ref`)."""
    fn = COMBINE_OPS[op]
    acc = bufs[0]
    for b in bufs[1:]:
        acc = fn(acc, b)
    return acc.clone() if acc is bufs[0] else acc


def sqrt_rn(x):
    """The correctly rounded f32 square root of f32 `x` (IEEE
    round-to-nearest, as the kernel's ``__fsqrt_rn`` and JAX's sqrt give
    it).  ``torch.sqrt`` on some CPU builds is off by one ulp on ~0.6% of
    inputs; the f64 root rounded to f32 is exact, since 53 >= 2 * 24 + 2
    bits rule out double rounding."""
    return torch.sqrt(x.double()).float()


def fused_adam_ref(g_bufs, p, m, v, wd_mask, c1, c2, *, lr, b1, b2, eps,
                   wd_coef, scale, out_dtype):
    """k gradient chunks summed in order, divided by `scale`, then AdamW:
    the op sequence of `repro.kernels.fused_update._fused_ref` and of
    `train.optimizer.apply_updates`, elementwise on f32 chunks.  Returns
    (new p in `out_dtype`, new m, new v), m and v in f32.

    Each step is one correctly rounded f32 operation: the sqrt through
    `sqrt_rn`, and the division by `scale` by a 0-d tensor (a CUDA tensor
    divided by a Python number is multiplied by its reciprocal)."""
    g = g_bufs[0]
    for r in g_bufs[1:]:
        g = g + r
    g = g / torch.full((), scale, dtype=torch.float32, device=g.device)
    c1 = torch.as_tensor(c1, dtype=torch.float32, device=g.device)
    c2 = torch.as_tensor(c2, dtype=torch.float32, device=g.device)
    m_n = b1 * m + (1.0 - b1) * g
    v_n = b2 * v + (1.0 - b2) * g * g
    upd = (m_n / c1) / (sqrt_rn(v_n / c2) + eps)
    upd = torch.where(wd_mask != 0, upd + wd_coef * p, upd)
    return (p - lr * upd).to(out_dtype), m_n, v_n


def ssd_ref(x, dt, a_log, b_mat, c_mat, h0=None):
    """Sequential-scan oracle of the SSD scan, one step at a time
    (`repro.kernels.ref.ssd_ref`).  x: (B,L,H,P); dt: (B,L,H); a_log: (H,)
    (negative: it is A, not a log); b_mat/c_mat: (B,L,G,N), head h reading
    group h // (H/G); h0: (B,H,P,N) or None.  Returns (y in x's dtype,
    the final f32 state)."""
    bsz, length, h, p = x.shape
    n = b_mat.shape[3]
    group = h // b_mat.shape[2]
    bm = b_mat.repeat_interleave(group, dim=2).float()     # (B,L,H,N)
    cm = c_mat.repeat_interleave(group, dim=2).float()
    state = (torch.zeros(bsz, h, p, n, device=x.device) if h0 is None
             else h0.float())
    xf, dtf, a = x.float(), dt.float(), a_log.float()
    ys = []
    for t in range(length):
        dt_t = dtf[:, t]                                     # (B,H)
        decay = torch.exp(a[None, :] * dt_t)[..., None, None]
        upd = dt_t[..., None, None] * xf[:, t, :, :, None] \
            * bm[:, t, :, None, :]                           # (B,H,P,N)
        state = decay * state + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", cm[:, t], state))
    return torch.stack(ys, 1).to(x.dtype), state


def ssd_chunked_ref(x, dt, a_log, b_mat, c_mat, h0=None, chunk: int = 128):
    """The chunked SSD in plain torch, the math of the kernel
    (`repro.kernels.ref.ssd_chunked_ref`): per chunk of Q steps the decay
    cumsum s, the intra-chunk term ((C B^T) * exp(s_t - s_u) * dt_u,
    u <= t) @ x, the inter-chunk term exp(s_t) * C @ state^T, and the
    state update exp(s_Q) * state + (x * dt * exp(s_Q - s))^T @ B; every
    product in f32.  L % chunk == 0.  The mask sits in the exponent:
    exp(where(u <= t, s_t - s_u, -1e30)), since exp of the positive
    difference above the diagonal overflows to inf and inf * 0 poisons
    the gradient.  Differentiable; the inter-chunk recurrence is a loop
    over the L / chunk chunks."""
    bsz, length, h, p = x.shape
    n = b_mat.shape[3]
    group = h // b_mat.shape[2]
    if length % chunk:
        raise ValueError(f"L={length} is not a multiple of chunk={chunk}")
    nc = length // chunk
    bm = b_mat.repeat_interleave(group, dim=2)
    cm = c_mat.repeat_interleave(group, dim=2)
    state = (torch.zeros(bsz, h, p, n, device=x.device) if h0 is None
             else h0.float())

    xc = x.reshape(bsz, nc, chunk, h, p).float()
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bc = bm.reshape(bsz, nc, chunk, h, n).float()
    cc = cm.reshape(bsz, nc, chunk, h, n).float()

    a_dt = a_log.float()[None, None, None, :] * dtc          # (B,nc,Q,H)
    s = torch.cumsum(a_dt, dim=2)
    s_last = s[:, :, -1:, :]

    idx = torch.arange(chunk, device=x.device)
    tri = idx[:, None] >= idx[None, :]

    cb = torch.einsum("bcthn,bcuhn->bchtu", cc, bc)
    st = s.transpose(2, 3)                                   # (B,nc,H,Q)
    delta = st[..., :, None] - st[..., None, :]              # (B,nc,H,Q,Q)
    decay = torch.exp(torch.where(tri, delta, NEG_INF))
    m = decay * cb * dtc.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bchtu,bcuhp->bcthp", m, xc)

    w = xc * (dtc * torch.exp(s_last - s))[..., None]        # (B,nc,Q,H,P)
    chunk_upd = torch.einsum("bcuhp,bcuhn->bchpn", w, bc)
    chunk_decay = torch.exp(s_last[:, :, 0, :])              # (B,nc,H)

    y_inter = []
    for c in range(nc):
        y_inter.append(
            torch.exp(s[:, c]).transpose(1, 2)[..., None]
            * torch.einsum("bthn,bhpn->bhtp", cc[:, c], state))  # (B,H,Q,P)
        state = chunk_decay[:, c, :, None, None] * state + chunk_upd[:, c]
    y_inter = torch.stack(y_inter, 1).transpose(2, 3)        # (B,nc,Q,H,P)
    y = (y_intra + y_inter).reshape(bsz, length, h, p).to(x.dtype)
    return y, state


# The chunk-parallel decomposition of the same function, phase by phase
# as csrc/ssd_scan.cu computes it: only the state is carried from chunk
# to chunk.  s is (B, nc, H, Q), states (B, nc, H, P, N), all f32.

def ssd_chunk_states_ref(x, dt, a_log, b_mat, chunk: int = 128, s=None):
    """Phase 1, parallel over (batch, chunk, head): s = cumsum(A dt)
    within each chunk, and the chunk's local state sum_u (w_u x_u) (x)
    B_u with w_u = dt_u exp(s_Q - s_u) (s_Q the very value s[Q-1]).
    Given `s` (B, nc, H, Q), the local states are formed from it instead
    (a kernel's product held on its own cumsums).  Returns (s, local)."""
    bsz, length, h, p = x.shape
    n = b_mat.shape[3]
    group = h // b_mat.shape[2]
    nc = length // chunk
    xc = x.reshape(bsz, nc, chunk, h, p).float()
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bc = b_mat.repeat_interleave(group, dim=2).reshape(
        bsz, nc, chunk, h, n).float()
    if s is None:
        s = torch.cumsum(a_log.float()[None, None, None, :] * dtc, dim=2)
    else:
        s = s.transpose(2, 3)
    w = xc * (dtc * torch.exp(s[:, :, -1:, :] - s))[..., None]
    local = torch.einsum("bcuhp,bcuhn->bchpn", w, bc)
    return s.transpose(2, 3).contiguous(), local


def ssd_state_passing_ref(local, s, h0=None):
    """Phase 2, sequential over the chunks: the state entering chunk c,
    S_in[c] = exp(s_Q[c-1]) S_in[c-1] + local[c-1], from h0 (or 0).
    Returns (entering, the final state)."""
    bsz, nc, h, p, n = local.shape
    state = (torch.zeros(bsz, h, p, n, device=local.device) if h0 is None
             else h0.float())
    decay = torch.exp(s[..., -1])                            # (B,nc,H)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = decay[:, c, :, None, None] * state + local[:, c]
    return torch.stack(entering, 1), state


def ssd_chunk_outputs_ref(x, dt, b_mat, c_mat, s, entering,
                          chunk: int = 128):
    """Phase 3, parallel over (batch, chunk, head): y = ((C B^T) *
    exp(s_t - s_u) * dt_u, u <= t) @ x + exp(s_t) (C @ S_in^T), in x's
    dtype; the mask in the exponent, as `ssd_chunked_ref` has it."""
    bsz, length, h, p = x.shape
    n = b_mat.shape[3]
    group = h // b_mat.shape[2]
    nc = length // chunk
    xc = x.reshape(bsz, nc, chunk, h, p).float()
    dtc = dt.reshape(bsz, nc, chunk, h).float().transpose(2, 3)
    bc = b_mat.repeat_interleave(group, dim=2).reshape(
        bsz, nc, chunk, h, n).float()
    cc = c_mat.repeat_interleave(group, dim=2).reshape(
        bsz, nc, chunk, h, n).float()
    idx = torch.arange(chunk, device=x.device)
    tri = idx[:, None] >= idx[None, :]
    delta = s[..., :, None] - s[..., None, :]                # (B,nc,H,Q,Q)
    m = (torch.exp(torch.where(tri, delta, NEG_INF))
         * torch.einsum("bcthn,bcuhn->bchtu", cc, bc) * dtc[..., None, :])
    y = (torch.einsum("bchtu,bcuhp->bcthp", m, xc)
         + torch.exp(s).transpose(2, 3)[..., None]
         * torch.einsum("bcthn,bchpn->bcthp", cc, entering))
    return y.reshape(bsz, length, h, p).to(x.dtype)

