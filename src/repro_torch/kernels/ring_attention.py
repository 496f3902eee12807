"""Per-KV-block attention partials for the fused ring-attention path: the
launching wrapper of csrc/ring_attention.cu (kernel 6).

Replaces the TPU kernel `repro/kernels/ring_attention.py::_partials_pallas`
(body `_partials_kernel`).  Ring attention (`core/fusion.ring_attention`)
sees the KV sequence one remote block at a time, so the kernel computes
the UN-NORMALISED online-softmax state of q against one block:

    acc = sum_j exp(s_j - m) v_j     (..., Hq, Lq, D)   f32
    m   = max_j s_j                  (..., Hq, Lq)      f32 (-1e30 if none)
    l   = sum_j exp(s_j - m)         (..., Hq, Lq)      f32

States of successive blocks merge with the flash rescaling
(`merge_partials`), and `finalize` applies the deferred division.
Masking is by GLOBAL positions (`q_pos`, and `k_pos` with -1 marking a
padded slot), so causal, window and ragged-edge semantics survive the
sequence sharding.

On the SIM backend every tensor carries a leading PE axis, and one launch
covers every PE (the reference vmaps its Pallas call over that axis): q
(P, B, Hq, Lq, D), k and v (P, B, Hkv, Lk, D), q_pos (P, Lq), k_pos
(P, Lk).  The unstacked shapes (no P axis) are accepted too.  Any D in
1..256 (k and v of one shape: the ring has no head dim of v of its own in
the reference).  The kernel handles any Lq and Lk itself, so nothing is
padded and the reference's `bq`/`bk` have no counterpart.

One call is one C entry of two CUDA kernels (`launches` counts entries):
the first writes the sum of v over the block and each `BK`-key tile's
min and max key position and count of valid keys into scratch this
wrapper allocates; the second
walks, per query tile, only the key tiles some of its rows may keep (a
wholly masked tile changes nothing for a row that keeps a key elsewhere,
and a row that keeps none is written from the sum of v), bf16 on the
tensor cores, f32 on the CUDA cores.  The CUDA source has the design.

Bound on the H100: at the ring step of the port's main path (16 PEs, B 1,
Hq 14, Hkv 2, Lq = Lk = 2048, D 64, bf16, causal, the diagonal block) the
function moves 196.9 MB (0.059 ms at 3.35 TB/s) and its 33.6M kept pairs
are 120.3 GFLOP of products (0.122 ms at the bf16 tensor-core rate):
bound by operations; a wholly masked block by bytes alone.

A CPU tensor goes to the plain version (`ref.ring_partials_ref`); a CUDA
tensor launches the kernel or raises.  `launches` counts the launches.
The gradient, where one is asked for, recomputes the block through the
plain version (`attn_block_partials`), on either device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _meta, ref

BK = 64            # keys per K/V tile of the kernel
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535

launches = 0


def _check(q, k, v, q_pos, k_pos, window, softcap):
    if q.dim() != 5 or k.dim() != 5 or v.dim() != 5 or q_pos.dim() != 2 \
            or k_pos.dim() != 2:
        raise ValueError("q, k, v must be (P, B, H, L, D) and q_pos, k_pos "
                         "(P, L), or all without the P axis")
    p, b, hq, lq, d = q.shape
    hkv, lk = k.shape[2], k.shape[3]
    if k.shape != v.shape or k.shape[:2] != (p, b) or k.shape[4] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q_pos.shape != (p, lq) or k_pos.shape != (p, lk):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / k_pos "
                         f"{tuple(k_pos.shape)}: want {(p, lq)} / {(p, lk)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if min(p, b, lq, lk) == 0:
        raise ValueError(f"empty q {tuple(q.shape)} or k {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                        f"takes float32 or bfloat16, all three the same")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError(f"positions must be int32, not {q_pos.dtype}/"
                        f"{k_pos.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} not in 1..{MAX_HEAD_DIM}")
    if hq > _MAX_GRID_YZ or p * b > _MAX_GRID_YZ:
        raise ValueError(f"Hq={hq} and P*B={p * b} must be at most "
                         f"{_MAX_GRID_YZ}")
    if len({t.device for t in (q, k, v, q_pos, k_pos)}) != 1:
        raise ValueError("q, k, v and the positions must be on one device")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap={softcap} must be > 0")


def _library() -> ctypes.CDLL:
    lib = _build.load("ring_attention")
    fn = lib.repro_ring_partials
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_ring_partials_tc.argtypes = ([ctypes.c_int] * 2
                                               + [ctypes.c_void_p] * 3)
        lib.repro_ring_partials_tc.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def attn_block_partials(q, k, v, q_pos, k_pos, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None,
                        sm_scale: float | None = None):
    """Un-normalised flash partials (acc, m, l) of q against ONE KV block
    (module docstring for the shapes).  Merge with `merge_partials`, then
    `finalize`.  Where q, k or v require a gradient the call is a
    `torch.autograd.Function` whose backward recomputes through
    `ref.ring_partials_ref` (kernel 4's rule, `ops.attention`); the
    reference's ring differentiates its plain partials the same way."""
    if q.dim() == 4:
        acc, m, l = attn_block_partials(
            q[None], k[None], v[None], q_pos[None], k_pos[None],
            causal=causal, window=window, softcap=softcap,
            sm_scale=sm_scale)
        return acc[0], m[0], l[0]
    _check(q, k, v, q_pos, k_pos, window, softcap)
    kw = dict(causal=causal, window=window, softcap=softcap,
              sm_scale=sm_scale if sm_scale is not None
              else 1.0 / math.sqrt(q.shape[-1]))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Partials.apply(q, k, v, q_pos, k_pos, kw)
    return _partials(q, k, v, q_pos, k_pos, **kw)


class _Partials(torch.autograd.Function):
    """Kernel 6 forward, plain-recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, kw):
        ctx.save_for_backward(q, k, v, q_pos, k_pos)
        ctx.kw = kw
        return _partials(q, k, v, q_pos, k_pos, **kw)

    @staticmethod
    def backward(ctx, g_acc, g_m, g_l):
        q, k, v, q_pos, k_pos = ctx.saved_tensors
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            out = ref.ring_partials_ref(q, k, v, q_pos, k_pos, **ctx.kw)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), (g_acc, g_m, g_l),
                                         allow_unused=True)
        return dq, dk, dv, None, None, None


def _partials(q, k, v, q_pos, k_pos, *, causal, window, softcap, sm_scale):
    """The partials of checked (P, ...) inputs: the plain version for a
    CPU tensor, one launch of the kernel for a CUDA one."""
    if q.device.type == "cpu":
        return ref.ring_partials_ref(q, k, v, q_pos, k_pos, causal=causal,
                                     window=window, softcap=softcap,
                                     sm_scale=sm_scale)
    global launches
    p, b, hq, lq, d = q.shape
    if q.device.type == "meta":
        # the positions have no values on meta: every pair counts (the
        # most the block can keep)
        acc = _meta.empty(q.shape, torch.float32)
        m = _meta.empty(q.shape[:-1], torch.float32)
        l = _meta.empty(q.shape[:-1], torch.float32)
        _meta.note("ring_attention", 4 * d * lq * k.shape[3] * p * b * hq,
                   _meta.nbytes(q, k, v, q_pos, k_pos, acc, m, l))
        launches += 1
        return acc, m, l
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos, k_pos = q_pos.contiguous(), k_pos.contiguous()
    lib = _library()
    hkv, lk = k.shape[2], k.shape[3]
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    # scratch: the sum of v per (PE, batch row, KV head), and per (PE, key
    # tile) the min and max valid key position and their count
    vsum = torch.empty((p * b * hkv, d), dtype=torch.float32,
                       device=q.device)
    bounds = torch.empty((p, -(-lk // BK), 4), dtype=torch.int32,
                         device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ring_partials(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            vsum.data_ptr(), bounds.data_ptr(), _DTYPES[q.dtype], p, b, hq,
            hkv, lq, lk, d, int(causal), window or 0, float(softcap or 0.0),
            float(sm_scale), stream)
    if err:
        raise RuntimeError("ring_attention launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return acc, m, l


def tensor_core_route(q, k, v) -> bool:
    """Whether the kernel computes these CUDA tensors on the tensor cores
    (bf16, D a multiple of 8, 16-byte-aligned q, k, v) or on the CUDA
    cores, as the C entry decides it."""
    return bool(_library().repro_ring_partials_tc(
        _DTYPES[q.dtype], q.shape[-1], q.data_ptr(), k.data_ptr(),
        v.data_ptr()))


def merge_partials(a, b):
    """Combine two un-normalised partial states (associative and, up to
    f32 rounding, order-insensitive: the flash rescaling rule)."""
    acc_a, m_a, l_a = a
    acc_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    wa = torch.exp(m_a - m)
    wb = torch.exp(m_b - m)
    acc = acc_a * wa[..., None] + acc_b * wb[..., None]
    l = l_a * wa + l_b * wb
    return acc, m, l


def finalize(state, dtype=None):
    """The deferred softmax division, out = acc / max(l, 1e-30), the
    epsilon-guarded division of the monolithic kernel, in `dtype` (default
    f32)."""
    acc, _, l = state
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out if dtype is None else out.to(dtype)
