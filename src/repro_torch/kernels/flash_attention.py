"""Flash-attention forward: the launching wrapper of csrc/flash_attention.cu.

Replaces the TPU kernel `repro/kernels/flash_attention.py::flash_attention`
(body `_attn_kernel`): GQA, causal, sliding window, tanh softcap and the
ragged `lk_valid` edge, with an f32 online softmax, masked logits at -1e30
and `out = acc / max(l, 1e-30)`.  Any head dim D of q and k in 1..256, and
a head dim Dv of v of its own in 1..256 (deepseek-v3's MLA: q/k 192, v
128); the output is (B, Hq, Lq, Dv).  The CUDA source and
`csrc/attn_tile.cuh` describe the design: bf16 at D and Dv multiples of 8
(every model's) on the tensor cores (wgmma, TMA), f32 on the CUDA cores;
only the key tiles some row of a query tile keeps are walked.

Bound on the H100: at the serving prefill's shapes (one request, Hq 14,
Hkv 2, Lq 128, Lk 256, D 64, bf16, causal) the function moves ~0.52 MB (q,
the output, and the 128 K/V rows of 256 that the causal mask keeps) and
does ~30 MFLOP of products, so it is bound by bytes (~0.16 us at
3.35 TB/s); at 32768 tokens by the products (1.95 ms at the bf16 rate).

A CPU tensor goes to the plain version (`ref.attention_ref`); a CUDA
tensor launches the kernel or raises; a meta tensor takes the meta path
(`_meta`: the launch counted, kept pairs x 2(D + Dv) operations a head).
`launches` counts the launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _meta, ref

BQ = 64            # query rows per block: Lq must be a multiple
BK = 64            # keys per K/V tile: Lk must be a multiple
MAX_HEAD_DIM = 256  # of q/k (D) and of v (Dv)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _check(q, k, v, window, softcap, lk_valid):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B, H, L, D)")
    b, hq, lq, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    hkv, lk = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                        f"takes float32 or bfloat16, all three the same")
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= v.shape[3] <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={d}, Dv={v.shape[3]}: each must be "
                         f"in 1..{MAX_HEAD_DIM}")
    if lq % BQ or lk % BK:
        raise ValueError(f"Lq={lq} must be a multiple of {BQ} and Lk={lk} "
                         f"of {BK} (ops.attention pads)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap={softcap} must be > 0")
    if not 0 <= lk_valid <= lk:
        raise ValueError(f"lk_valid={lk_valid} outside [0, {lk}]")


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_flash_attention_tc.argtypes = ([ctypes.c_int] * 3
                                                 + [ctypes.c_void_p] * 3)
        lib.repro_flash_attention_tc.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    sm_scale: float | None = None,
                    lk_valid: int | None = None):
    """q: (B, Hq, Lq, D); k: (B, Hkv, Lk, D); v: (B, Hkv, Lk, Dv) ->
    (B, Hq, Lq, Dv); Lq % BQ == Lk % BK == 0.  Keys at or past `lk_valid`
    (default Lk) are masked."""
    lk = k.shape[2] if k.dim() == 4 else 0
    lk_valid = lk if lk_valid is None else int(lk_valid)
    _check(q, k, v, window, softcap, lk_valid)
    b, hq, lq, d = q.shape
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, sm_scale=sm_scale,
                                 lk_valid=lk_valid)
    global launches
    if q.device.type == "meta":
        out = _meta.empty((b, hq, lq, v.shape[3]), q.dtype)
        pairs = _meta.kept_pairs(lq, k.shape[2], bool(causal), window,
                                 lk_valid)
        _meta.note("flash_attention", 2 * (d + v.shape[3]) * pairs * b * hq,
                   _meta.nbytes(q, k, v, out))
        launches += 1
        return out
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    lib = _library()
    dv = v.shape[3]
    out = torch.empty((b, hq, lq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, hq, k.shape[1], lq, lk, d, dv, lk_valid,
            int(causal), window or 0, float(softcap or 0.0), float(sm_scale),
            stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return out


def tensor_core_route(q, k, v) -> bool:
    """Whether the kernel computes these CUDA tensors on the tensor cores
    (bf16, D and Dv multiples of 8, 16-byte-aligned q, k, v) or on the
    CUDA cores, as the C entry decides it."""
    return bool(_library().repro_flash_attention_tc(
        _DTYPES[q.dtype], q.shape[-1], v.shape[-1], q.data_ptr(),
        k.data_ptr(), v.data_ptr()))
