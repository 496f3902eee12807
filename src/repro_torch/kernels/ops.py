"""Public ops over the kernels, with the signatures of
`repro.kernels.ops`.  The wrapper decides by the tensors' device: the plain
version for CPU tensors, the kernel for CUDA tensors.

`attention` pads its inputs to the kernel's tile multiples (the ragged
edge is masked through `lk_valid`) and slices the padding off.  It is a
`torch.autograd.Function`, as the reference's is a `jax.custom_vjp`: the
forward is the flash kernel (its plain version on the CPU), the backward
recomputes through `ref.attention_ref` and differentiates that, on either
device.  `ssd` zero-pads L to a multiple of the chunk and slices y back;
it is a Function of the same shape, its backward recomputing through
`ref.ssd_chunked_ref` (the function the reference trains through).  The
copy, combine and AdamW kernels handle any length and region themselves
(a scalar edge path where 16-byte vectors do not fit), so `put_copy`,
`dma_copy`, `reduce_combine` and `fused_adam_update` need no edge
padding, which the TPU kernels needed for their (32, 128) tiles."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import flash_attention as _fa
from . import fused_update as _fu
from . import put_copy as _pc
from . import reduce_combine as _rc
from . import ref
from . import ssd_scan as _ssd


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
    return _Attention.apply(q, k, v, causal, window, softcap, sm_scale, bq,
                            bk)


class _Attention(torch.autograd.Function):
    """Flash forward, reference-recompute backward
    (`repro.kernels.ops._attention`'s custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, sm_scale, bq, bk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        sm_scale=sm_scale)
        lq, lk = q.shape[2], k.shape[2]
        out = _fa.flash_attention(
            _pad_seq(q, bq), _pad_seq(k, bk), _pad_seq(v, bk),
            lk_valid=lk, **ctx.opts)
        return out[:, :, :lq]

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.attention_ref(q, k, v, **ctx.opts)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None, None, None


def ssd(x, dt, a_log, b_mat, c_mat, h0=None, *,
        chunk: int = _ssd.DEFAULT_CHUNK):
    """SSD scan: (y, h_final), `repro.kernels.ops.ssd`'s function.

    x: (B, L, H, P); dt: (B, L, H) f32; a_log: (H,) f32, negative (A
    itself, not its log); b_mat, c_mat: (B, L, G, N) in x's dtype; h0:
    (B, H, P, N) f32 or None.  Any L: the sequence is zero-padded to a
    multiple of `chunk` (a padded step has dt = 0, so it leaves the state
    alone) and y is sliced back to L.  The forward is kernel 7 on the card
    (its plain version on the CPU); the backward recomputes through
    `ref.ssd_chunked_ref`."""
    return _Ssd.apply(x, dt, a_log, b_mat, c_mat, h0, chunk)


def _ssd_pad(x, dt, b_mat, c_mat, chunk):
    """x, dt, b_mat, c_mat zero-padded along L to a multiple of `chunk`
    (a padded step has dt = 0: it leaves the state alone)."""
    pad = (-x.shape[1]) % chunk
    if pad:
        x, b_mat, c_mat = (F.pad(t, (0, 0, 0, 0, 0, pad))
                           for t in (x, b_mat, c_mat))
        dt = F.pad(dt, (0, 0, 0, pad))
    return x, dt, b_mat, c_mat


def _ssd_padded(x, dt, a_log, b_mat, c_mat, h0, chunk, scan):
    length = x.shape[1]
    x, dt, b_mat, c_mat = _ssd_pad(x, dt, b_mat, c_mat, chunk)
    y, h = scan(x, dt, a_log, b_mat, c_mat, h0, chunk=chunk)
    return y[:, :length], h


class _Ssd(torch.autograd.Function):
    """Kernel forward, chunked-reference-recompute backward."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b_mat, c_mat, h0, chunk):
        ctx.save_for_backward(x, dt, a_log, b_mat, c_mat, h0)
        ctx.chunk = chunk
        return _ssd_padded(x, dt, a_log, b_mat, c_mat, h0, chunk,
                           _ssd.ssd_scan)

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        want = [i for i, t in enumerate(saved)
                if t is not None and ctx.needs_input_grad[i]]
        inputs = [t.detach().requires_grad_(i in want) if t is not None
                  else None for i, t in enumerate(saved)]
        with torch.enable_grad():
            y, h = _ssd_padded(*inputs, ctx.chunk, ref.ssd_chunked_ref)
        grads = torch.autograd.grad((y, h), [inputs[i] for i in want],
                                    (gy, gh), allow_unused=True)
        out = [None] * 7
        for i, g in zip(want, grads):
            out[i] = g
        return tuple(out)


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


def fused_adam_update(g_bufs, p, m, v, wd_mask, c1, c2, *, lr: float,
                      b1: float, b2: float, eps: float, wd_coef: float,
                      scale: float = 1.0, out_dtype=None):
    """Combine + mean + AdamW on flat f32 chunks (kernel 5).

    g_bufs: 1 to 4 f32 gradient partials to sum in order (the local ring
    partial and the final incoming chunk); p/m/v: f32 param and moment
    chunks; wd_mask: int8, nonzero where weight decay applies; c1/c2:
    ``1 - beta**t``.  Returns (new_p in `out_dtype`, default p's dtype;
    new_m, new_v in f32)."""
    out_dtype = p.dtype if out_dtype is None else out_dtype
    return _fu.fused_adam(g_bufs, p, m, v, wd_mask, c1, c2, lr=lr, b1=b1,
                          b2=b2, eps=eps, wd_coef=wd_coef, scale=scale,
                          out_dtype=out_dtype)
