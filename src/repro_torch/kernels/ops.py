"""Public ops over the kernels, with the signatures of
`repro.kernels.ops`.  The wrapper decides by the tensors' device: the plain
version for CPU tensors, the kernel for CUDA tensors.

`attention` pads its inputs to the kernel's tile multiples (the ragged
edge is masked through `lk_valid`) and slices the padding off.  The copy
and combine kernels handle any row length and region themselves (a scalar
edge path where 16-byte vectors do not fit), so `put_copy`, `dma_copy`
and `reduce_combine` need no edge padding, which the TPU kernels needed
for their (32, 128) tiles.  Forward only: nothing here takes gradients."""
from __future__ import annotations

import torch.nn.functional as F

from . import flash_attention as _fa
from . import put_copy as _pc
from . import reduce_combine as _rc


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


def put_copy(src):
    """The shmem_put byte mover: an identity copy of `src` (any shape of
    at least one dim), through the row-copy kernel."""
    if src.dim() == 0:
        raise ValueError("put_copy needs at least one dim")
    x2 = src.reshape(-1, src.shape[-1]) if src.dim() != 2 else src
    return _pc.put_copy(x2).reshape(src.shape)


def dma_copy(src, dst, *, src_origin, dst_origin, region):
    """2D strided descriptor copy: `region` of 2D `src` at `src_origin`
    into a copy of 2D `dst` at `dst_origin`; returns the updated copy."""
    (sr, sc), (dr, dc), (nr, nc) = src_origin, dst_origin, region
    plan = _pc.DmaPlan([[sr, sc, dr, dc, nr, nc]], src.shape, dst.shape)
    return _pc.dma_copy(src, dst.clone(), plan)


def reduce_combine(bufs, op: str = "sum"):
    """Elementwise `op` (sum, prod, max, min) folded over k >= 2
    same-shape buffers in order."""
    return _rc.reduce_combine(bufs, op)
