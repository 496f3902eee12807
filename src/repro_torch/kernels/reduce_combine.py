"""reduce_combine: the launching wrapper of csrc/reduce_combine.cu.

Replaces the TPU kernel `repro/kernels/reduce_combine.py::
reduce_combine_2d` (body `_combine_kernel`): sum, prod, max or min folded
over k >= 2 same-shape buffers, in order from ``bufs[0]``, in the storage
dtype.  It is the combine of every reduction stage of the SIM runtime on
the card (`core/collectives.OPS`) and the fold of `NocSimNetOps`' waves.

Bound by bytes: k buffers read once, one written (the CUDA source
describes the design).  A CPU tensor goes to the plain version
(`ref.reduce_combine_ref`); a CUDA tensor launches the kernel or raises,
also for a dtype the kernel lacks; a meta tensor takes the meta path
(`_meta`: k - 1 operations an element).  `launches` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _meta, ref
from .put_copy import row_stride

OPS = {"sum": 0, "prod": 1, "max": 2, "min": 3}
DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
          torch.float16: 3, torch.int32: 4, torch.int64: 5, torch.int16: 6,
          torch.int8: 7, torch.uint8: 8}
MAX_K = 32          # buffers per launch (kMaxK in the CUDA source)

launches = 0


def _library() -> ctypes.CDLL:
    lib = _build.load("reduce_combine")
    fn = lib.repro_reduce_combine
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(bufs, op: str, rows: int, cols: int) -> torch.Tensor:
    """One launch over at most MAX_K buffers viewed as (rows, cols)."""
    lds, keep = [], []
    for b in bufs:
        b = b.reshape(rows, cols) if b.dim() == 0 else b
        ld = row_stride(b)
        if ld is None:
            b = b.contiguous()
            ld = row_stride(b)
        keep.append(b)
        lds.append(ld)
    global launches
    first = keep[0]
    out = torch.empty(bufs[0].shape, dtype=first.dtype, device=first.device)
    k = len(keep)
    if first.device.type == "meta":
        _meta.note("reduce_combine", (k - 1) * out.numel(),
                   (k + 1) * _meta.nbytes(out))
        launches += 1
        return out
    lib = _library()
    with torch.cuda.device(first.device):
        err = lib.repro_reduce_combine(
            (ctypes.c_void_p * k)(*[b.data_ptr() for b in keep]),
            (ctypes.c_int64 * k)(*lds), k, out.data_ptr(), rows, cols,
            DTYPES[first.dtype], OPS[op],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("reduce_combine launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return out


def reduce_combine(bufs, op: str = "sum") -> torch.Tensor:
    """``op`` over k >= 2 tensors of one shape, dtype and device, folded in
    order from ``bufs[0]``; a new contiguous tensor.  Each buffer's rows
    (dim 0) may sit at any stride, as the blocks of a PE-stacked tensor do.
    More than MAX_K buffers fold in consecutive launches."""
    bufs = list(bufs)
    if len(bufs) < 2:
        raise ValueError("reduce_combine needs k >= 2 buffers")
    if op not in OPS:
        raise ValueError(f"op {op!r} not in {sorted(OPS)}")
    b0 = bufs[0]
    for b in bufs[1:]:
        if b.shape != b0.shape or b.dtype != b0.dtype or \
                b.device != b0.device:
            raise ValueError(f"buffers differ: {tuple(b.shape)} {b.dtype} "
                             f"{b.device} vs {tuple(b0.shape)} {b0.dtype} "
                             f"{b0.device}")
    if b0.device.type == "cpu":
        return ref.reduce_combine_ref(bufs, op)
    if b0.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {b0.device}")
    if b0.dtype not in DTYPES:
        raise TypeError(f"reduce_combine has no kernel for {b0.dtype}")
    if b0.numel() == 0:
        return torch.empty_like(b0, memory_format=torch.contiguous_format)
    rows = b0.shape[0] if b0.dim() else 1
    cols = b0.numel() // rows
    acc = _launch(bufs[:MAX_K], op, rows, cols)
    for lo in range(MAX_K, len(bufs), MAX_K - 1):
        acc = _launch([acc] + bufs[lo:lo + MAX_K - 1], op, rows, cols)
    return acc
