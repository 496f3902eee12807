"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper and the ground truth the kernels are held to on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  sm_scale=None, lk_valid=None):
    """q: (B,Hq,Lq,D); k,v: (B,Hkv,Lk,D). Dense reference attention.

    Products of the input dtype accumulate in f32 (the inputs are upcast
    before each contraction, which is exact for bf16), the softmax runs in
    f32, and the probabilities are rounded to v's dtype before the second
    contraction — the arithmetic of `repro.kernels.ref.attention_ref`."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    group = hq // hkv
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    lk_valid = lk if lk_valid is None else lk_valid
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * sm_scale
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
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vv.float())
    return out.to(q.dtype)


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
