"""Public ops over the kernels: each pads its inputs to the kernel's tile
multiples (the ragged edge is masked through `lk_valid`), calls the
kernel's wrapper, and slices the padding off.  The wrapper decides by the
tensors' device: the plain version for CPU tensors, the kernel for CUDA
tensors.  Forward only: the serving path takes no gradients."""
from __future__ import annotations

import torch.nn.functional as F

from . import flash_attention as _fa


def _pad_seq(x, mult: int):
    """Zero-pad dim 2 (the sequence) to a multiple of `mult`, contiguous."""
    p = (-x.shape[2]) % mult
    if p:
        x = F.pad(x, (0, 0, 0, p))
    return x.contiguous()


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              sm_scale=None, bq: int = _fa.BQ, bk: int = _fa.BK):
    """q: (B,Hq,Lq,D); k,v: (B,Hkv,Lk,D) -> (B,Hq,Lq,D) in q's dtype.

    Query row i sits at position i and key j at position j (the causal
    mask is k_pos <= q_pos), as in `repro.kernels.ops.attention`.  The
    padding multiples `bq`/`bk` must be multiples of the kernel's tiles
    (`BQ` query rows, `BK` keys)."""
    if bq % _fa.BQ or bk % _fa.BK or bq <= 0 or bk <= 0:
        raise ValueError(f"bq={bq}, bk={bk}: the kernel needs positive "
                         f"multiples of {_fa.BQ} and {_fa.BK}")
    lq, lk = q.shape[2], k.shape[2]
    out = _fa.flash_attention(
        _pad_seq(q, bq), _pad_seq(k, bk), _pad_seq(v, bk), causal=causal,
        window=window, softcap=softcap, sm_scale=sm_scale, lk_valid=lk)
    return out[:, :, :lq]
