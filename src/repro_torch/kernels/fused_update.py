"""fused_update: the launching wrapper of csrc/fused_update.cu (kernel 5).

Replaces the TPU kernel `repro/kernels/fused_update.py::
fused_adam_update_2d` (body `_fused_kernel`): k gradient chunks summed in
order, divided by the mean scale, and fed straight into the AdamW
moment/param update in one pass, so the fully reduced gradient chunk of
the fused reduce-scatter (`core/fusion.fused_rs_adam`) never makes a
round trip through memory before the optimizer reads it.  The arithmetic
is that of `train/optimizer.apply_updates`, operation for operation, so
the fused path is bit for bit equal to the unfused one.

Bound by bytes: per element (4k + 13) bytes read and 12 written (the CUDA
source describes the design).  The TPU kernel padded to (32, 128) tiles;
this one takes any length.  A CPU tensor goes to the plain version
(`ref.fused_adam_ref`); a CUDA tensor launches the kernel or raises; a
meta tensor takes the meta path (`_meta`: the bytes above, k - 1 + 13
operations an element).  `launches` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _meta, ref
from . import reduce_combine as _rc
from .put_copy import row_stride

MAX_K = 4          # gradient chunks per launch (kMaxK in the CUDA source)
OUT_DTYPES = (torch.float32, torch.bfloat16)

launches = 0


def combine_chunks(bufs, op: str = "sum"):
    """k-ary elementwise combine of same-shape chunks (any dtype), the
    fused path's reduction stage on its own: one chunk is returned as it
    is, more go through the reduce_combine kernel."""
    bufs = list(bufs)
    if len(bufs) == 1:
        return bufs[0]
    return _rc.reduce_combine(bufs, op)


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_update")
    fn = lib.repro_fused_adam
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] + [ctypes.c_float] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(g_bufs, p, m, v, wd_mask, out_dtype):
    if not 1 <= len(g_bufs) <= MAX_K:
        raise ValueError(f"{len(g_bufs)} gradient chunks: the kernel takes "
                         f"1 to {MAX_K}")
    if p.dim() not in (1, 2):
        raise ValueError(f"p of shape {tuple(p.shape)}: 1-D or (rows, cols)")
    for name, t in [("m", m), ("v", v), ("wd_mask", wd_mask)] + [
            (f"g_bufs[{i}]", g) for i, g in enumerate(g_bufs)]:
        if t.shape != p.shape:
            raise ValueError(f"{name} of shape {tuple(t.shape)} != p's "
                             f"{tuple(p.shape)}")
        if t.device != p.device:
            raise ValueError(f"{name} on {t.device}, p on {p.device}")
    for name, t in [("p", p), ("m", m), ("v", v)] + [
            (f"g_bufs[{i}]", g) for i, g in enumerate(g_bufs)]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the kernel takes float32")
    if wd_mask.dtype != torch.int8:
        raise TypeError(f"wd_mask is {wd_mask.dtype}: the kernel takes int8")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype {out_dtype} not in {OUT_DTYPES}")


def fused_adam(g_bufs, p, m, v, wd_mask, c1, c2, *, lr: float, b1: float,
               b2: float, eps: float, wd_coef: float, scale: float = 1.0,
               out_dtype=torch.float32):
    """Combine + mean + AdamW on f32 chunks of one shape: 1-D, or
    (rows, cols) as the PE-stacked chunks of a SIM bucket (each row one
    PE's chunk; the update is elementwise, so all rows are one launch).
    `wd_mask` (int8) is nonzero where weight decay applies; c1/c2 are
    ``1 - beta**t`` as 0-d tensors (or floats).  Gradient chunks may sit
    at any row stride; the rest is made contiguous.  Returns (new p in
    `out_dtype`, new m, new v)."""
    g_bufs = list(g_bufs)
    _check(g_bufs, p, m, v, wd_mask, out_dtype)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd_coef=wd_coef, scale=scale)
    if p.device.type == "cpu":
        return ref.fused_adam_ref(g_bufs, p, m, v, wd_mask, c1, c2,
                                  out_dtype=out_dtype, **kw)
    global launches
    if p.device.type == "meta":
        new_p = _meta.empty(p.shape, out_dtype)
        new_m, new_v = _meta.empty(m.shape, m.dtype), \
            _meta.empty(v.shape, v.dtype)
        _meta.note("fused_update", (len(g_bufs) + 12) * p.numel(),
                   _meta.nbytes(*g_bufs, p, m, v, wd_mask, new_p, new_m,
                                new_v))
        launches += 1
        return new_p, new_m, new_v
    if p.device.type != "cuda":
        raise ValueError(f"no kernel for device {p.device}")
    rows, cols = (1, p.shape[0]) if p.dim() == 1 else tuple(p.shape)
    p, m, v, wd_mask = (t.contiguous() for t in (p, m, v, wd_mask))
    grads, lds = [], []
    for g in g_bufs:
        g2 = g.reshape(rows, cols) if g.dim() == 1 else g
        ld = row_stride(g2)
        if ld is None:
            g2 = g2.contiguous()
            ld = cols
        grads.append(g2)
        lds.append(ld)
    hyper = torch.stack([torch.as_tensor(c, dtype=torch.float32,
                                         device=p.device) for c in (c1, c2)])
    new_p = torch.empty(p.shape, dtype=out_dtype, device=p.device)
    new_m, new_v = torch.empty_like(m), torch.empty_like(v)
    if p.numel() == 0:
        return new_p, new_m, new_v
    k = len(grads)
    lib = _library()
    with torch.cuda.device(p.device):
        err = lib.repro_fused_adam(
            (ctypes.c_void_p * k)(*[g.data_ptr() for g in grads]),
            (ctypes.c_int64 * k)(*lds), k, p.data_ptr(), m.data_ptr(),
            v.data_ptr(), wd_mask.data_ptr(), hyper.data_ptr(),
            new_p.data_ptr(), new_m.data_ptr(), new_v.data_ptr(), rows, cols,
            int(out_dtype == torch.bfloat16), lr, b1, b2, 1.0 - b1, 1.0 - b2,
            eps, wd_coef, scale, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("fused_adam launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return new_p, new_m, new_v
