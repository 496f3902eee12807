"""Mamba2 SSD chunked scan: the launching wrapper of csrc/ssd_scan.cu.

Replaces the TPU kernel `repro/kernels/ssd_scan.py::ssd_scan` (body
`_ssd_kernel`), the hot spot of the ssm and hybrid families' prefill:
per (batch, head), over chunks of `chunk` steps, the decay cumsum, the
masked decay-weighted C B^T applied to x, the inter-chunk term from the
carried (P, N) f32 state, and the state update.  The CUDA source
describes the design: one entry launches three CUDA kernels (the chunk
states, the state passing, the chunk outputs), the products on the
tensor cores.

Bound on the H100: at the mamba2-2.7b prefill's shapes (Bt 1, L 32768,
H 80, P 64, G 1, N 128, chunk 128, bf16) the function moves ~0.70 GB
(0.21 ms at 3.35 TB/s) and its products, the kept u <= t pairs and C B^T
once per group, are 108 GFLOP (0.11 ms at the bf16 tensor-core rate): it
is bound by bytes.

A CPU tensor goes to the plain version (`ref.ssd_chunked_ref`); a CUDA
tensor launches the kernel or raises; a meta tensor takes the meta path
(`_meta`: the bytes above and the kept pairs' products, `work`).  x, B
and C may be views with any batch and step strides whose head (group)
rows are contiguous, as the slices of `mamba2`'s fused projection are;
other layouts are copied to contiguous first.  The wrapper allocates
the kernel's scratch: the chunks' states (Bt, L/chunk, H, P, N) f32 (671
MB at the prefill) and their cumsums (Bt, L/chunk, H, chunk) f32, freed
after the call.
`launches` counts the entries (one per call, whatever it launches).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _meta, ref

DEFAULT_CHUNK = 128
MAX_CHUNK = 128            # the kernel's warp scan holds 4 steps a lane
MAX_P = 64                 # the kernel's register tiles (kMaxP, kMaxN)
MAX_N = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _check(x, dt, a_log, b_mat, c_mat, h0, chunk):
    if x.dim() != 4 or dt.dim() != 3 or a_log.dim() != 1 \
            or b_mat.dim() != 4 or c_mat.dim() != 4:
        raise ValueError("x (B,L,H,P), dt (B,L,H), a_log (H,), b/c "
                         "(B,L,G,N) have the wrong number of dims")
    bsz, length, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if dt.shape != (bsz, length, h) or a_log.shape != (h,) \
            or b_mat.shape != (bsz, length, g, n) or c_mat.shape != b_mat.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a_log {tuple(a_log.shape)}, b {tuple(b_mat.shape)},"
                         f" c {tuple(c_mat.shape)} do not agree")
    if g == 0 or h % g:
        raise ValueError(f"H={h} is not a multiple of G={g}")
    if h0 is not None and h0.shape != (bsz, h, p, n):
        raise ValueError(f"h0 {tuple(h0.shape)} is not {(bsz, h, p, n)}")
    if x.dtype not in _DTYPES or b_mat.dtype != x.dtype \
            or c_mat.dtype != x.dtype:
        raise TypeError(f"x/b/c dtypes {x.dtype}/{b_mat.dtype}/"
                        f"{c_mat.dtype}: float32 or bfloat16, all the same")
    for name, t in (("dt", dt), ("a_log", a_log), ("h0", h0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    if not 0 < chunk <= MAX_CHUNK or chunk % 4 or length % chunk:
        raise ValueError(f"chunk={chunk}: a multiple of 4 in (0, "
                         f"{MAX_CHUNK}] that divides L={length} (ops.ssd "
                         f"pads L)")
    if p % 4 or n % 4 or not 0 < p <= MAX_P or not 0 < n <= MAX_N:
        raise ValueError(f"P={p} and N={n} must be multiples of 4, P <= "
                         f"{MAX_P}, N <= {MAX_N}")
    devices = {t.device for t in (x, dt, a_log, b_mat, c_mat, h0)
               if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.repro_ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _rows(t):
    """`t` itself if each (batch, step, head) row is contiguous (any batch
    and step strides), else a contiguous copy."""
    if t.stride(3) == 1 and t.stride(2) == t.shape[3]:
        return t
    return t.contiguous()


def work(bsz, length, h, p, n, g, chunk) -> int:
    """The products of one entry: per chunk the kept pairs u <= t of C
    B^T once per group, and per head the intra-chunk term, C @ state^T
    and the state update."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 2 * n * pairs * g + h * (2 * p * pairs + 4 * chunk * n * p)
    return bsz * (length // chunk) * per_chunk


def _aligned(t):
    """`t` contiguous with a 16-byte aligned start (the kernel's float4
    reads of h0)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, dt, a_log, b_mat, c_mat, h0, chunk, phases):
    """One entry of the kernel on CUDA tensors: (y, final state, states,
    s), with `states` and `s` the scratch after `phases` phases."""
    global launches
    bsz, length, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    nc = length // chunk
    if x.device.type == "meta":
        y = _meta.empty((bsz, length, h, p), x.dtype)
        hout = _meta.empty((bsz, h, p, n), torch.float32)
        states = _meta.empty((bsz, nc, h, p, n), torch.float32)
        s = _meta.empty((bsz, nc, h, chunk), torch.float32)
        _meta.note("ssd_scan", work(bsz, length, h, p, n, g, chunk),
                   _meta.nbytes(x, dt, a_log, b_mat, c_mat, h0, y, hout))
        launches += 1
        return y, hout, states, s
    lib = _library()
    x, b_mat, c_mat = _rows(x), _rows(b_mat), _rows(c_mat)
    dt, a_log = dt.contiguous(), a_log.contiguous()
    h0 = None if h0 is None else _aligned(h0)
    dev = x.device
    y = torch.empty((bsz, length, h, p), dtype=x.dtype, device=dev)
    hout = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    states = torch.empty((bsz, nc, h, p, n), dtype=torch.float32, device=dev)
    s = torch.empty((bsz, nc, h, chunk), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), hout.data_ptr(), states.data_ptr(), s.data_ptr(),
            _DTYPES[x.dtype], bsz, length, h, g, p, n, chunk, phases,
            x.stride(0), x.stride(1), b_mat.stride(0), b_mat.stride(1),
            c_mat.stride(0), c_mat.stride(1), stream)
    if err:
        raise RuntimeError("ssd_scan launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    launches += 1
    return y, hout, states, s


def ssd_scan(x, dt, a_log, b_mat, c_mat, h0=None, *,
             chunk: int = DEFAULT_CHUNK):
    """x: (B, L, H, P); dt: (B, L, H) f32; a_log: (H,) f32 (negative: A
    itself); b_mat, c_mat: (B, L, G, N) in x's dtype, H % G == 0; h0:
    (B, H, P, N) f32 or None.  L % chunk == 0.  Returns (y in x's dtype,
    the final f32 state)."""
    _check(x, dt, a_log, b_mat, c_mat, h0, chunk)
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, a_log, b_mat, c_mat, h0,
                                   chunk=chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {x.device}")
    y, hout, _, _ = _launch(x, dt, a_log, b_mat, c_mat, h0, chunk, 3)
    return y, hout


def ssd_scan_phases(x, dt, a_log, b_mat, c_mat, h0=None, *,
                    chunk: int = DEFAULT_CHUNK) -> dict:
    """The kernel's intermediates, for holding each phase to its plain
    form (`ref.ssd_chunk_states_ref`, `ssd_state_passing_ref`,
    `ssd_chunk_outputs_ref`): {"s": (B, nc, H, chunk) cumsums,
    "chunk_states": (B, nc, H, P, N) each chunk's local state,
    "entering": the states entering each chunk, "y", "final"}.  Two
    entries on CUDA (one stopped after phase 1); the plain forms on the
    CPU."""
    _check(x, dt, a_log, b_mat, c_mat, h0, chunk)
    if x.device.type == "cpu":
        s, local = ref.ssd_chunk_states_ref(x, dt, a_log, b_mat, chunk)
        entering, final = ref.ssd_state_passing_ref(local, s, h0)
        y = ref.ssd_chunk_outputs_ref(x, dt, b_mat, c_mat, s, entering,
                                      chunk)
        return dict(s=s, chunk_states=local, entering=entering, y=y,
                    final=final)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {x.device}")
    _, _, local, s = _launch(x, dt, a_log, b_mat, c_mat, h0, chunk, 1)
    y, final, entering, _ = _launch(x, dt, a_log, b_mat, c_mat, h0, chunk, 3)
    return dict(s=s, chunk_states=local, entering=entering, y=y, final=final)
