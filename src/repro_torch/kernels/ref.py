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
