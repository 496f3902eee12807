"""Paged decode attention: the launching wrapper of csrc/paged_decode.cu.

Replaces no TPU kernel: the reference's paged decode
(`repro/models/layers.py` `attention_paged`, its L == 1 branch) is plain
jnp, a gather of every row's pages out to max_seq and then `_attend_mq`.
The kernel computes that function on the page pool in place: q (B, Hq,
hd) of one decode token a row attends over the positions [pos - window +
1, pos] of its row, read through the row's page table, in f32 (q /
sqrt(hd), the tanh softcap, an exact softmax, acc / max(l, 1e-30)).

Bound on the H100 by the bytes of the live K/V rows: at internlm2-20b's
chat decode (64 rows of ~485 live positions, Hkv 8, hd 128, bf16) a
layer reads ~127 MB, ~38 us at 3.35 TB/s, with about `group` f32
operations a byte.  The kernel reads only the pages that hold a live
position, each K/V row once for its whole group of q heads, bf16 widened
in registers; splits of a row's pages run in parallel and a second
kernel combines them in order.  The CUDA source has the design.  Every
row's work and order of summation depend only on its own position and
the pool's static shape, so a row's result is the same bit for bit
batched or alone.

A CPU tensor goes to the plain version (`ref.paged_decode_ref`: the
gather and `_attend_mq`'s arithmetic); a CUDA tensor launches the kernel
or raises.  A decode step's layers share one `decode_rows`: the page
table and positions converted and checked once a step, the layer shapes
checked at the first layer, so a later layer's launch costs the host
little more than one allocation and the C call.  `launches` counts the
launches (one C entry of two CUDA kernels).
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build, ref

MAX_HEAD_DIM = 256
SPLIT_POSITIONS = 256    # a split's positions, rounded to whole pages
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CURRENT = contextlib.nullcontext()     # the launch's device is current

launches = 0


def _check(q, pool_k, pool_v, page_table, positions, q2slot):
    if q.dim() != 3 or pool_k.dim() != 4 or page_table.dim() != 2 \
            or positions.dim() != 1:
        raise ValueError("q must be (B, Hq, hd), the pools (num_pages, "
                         "page_size, Hkv, hd), page_table (B, max_pages) "
                         "and positions (B,)")
    b, hq, hd = q.shape
    if pool_v.shape != pool_k.shape or pool_k.shape[3] != hd:
        raise ValueError(f"pools {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.shape[0] != b or positions.shape[0] != b:
        raise ValueError(f"page_table {tuple(page_table.shape)} / positions "
                         f"{tuple(positions.shape)}: want {b} rows")
    hkv = pool_k.shape[2]
    if q2slot is None and hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if q2slot is not None and q2slot.shape != (hq,):
        raise ValueError(f"q2slot {tuple(q2slot.shape)}: want ({hq},)")
    if q.dtype not in _DTYPES or pool_k.dtype not in _DTYPES \
            or pool_v.dtype != pool_k.dtype:
        raise TypeError(f"dtypes q {q.dtype}, pools {pool_k.dtype}/"
                        f"{pool_v.dtype}: the kernel takes float32 or "
                        f"bfloat16, both pools the same")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: must be a multiple of 8 in "
                         f"8..{MAX_HEAD_DIM}")
    if pool_k.shape[0] * pool_k.shape[1] >= 2 ** 31:
        raise ValueError(f"{pool_k.shape[0]} pages of {pool_k.shape[1]} "
                         f"rows: the kernel indexes rows in 32 bits")


def _library() -> ctypes.CDLL:
    lib = _build.load("paged_decode")
    fn = lib.repro_paged_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


class DecodeRows:
    """What every layer's launch of one decode step shares, checked and
    converted once a step (`decode_rows`): the page table (B, max_pages)
    and the positions (B,) as contiguous int64, the splits of a row, the
    device's current stream on a card, the context that makes the device
    current for the launch (none when it is already), and the layer
    shapes already checked."""

    __slots__ = ("table", "positions", "page_size", "split_pages", "splits",
                 "stream", "device", "on_device", "checked")

    def __init__(self, table, positions, page_size, device, stream=None,
                 on_device=None):
        self.table, self.positions = table, positions
        self.page_size = page_size
        self.split_pages = max(1, SPLIT_POSITIONS // page_size)
        self.splits = -(-table.shape[1] // self.split_pages)
        self.device, self.stream, self.on_device = device, stream, on_device
        self.checked = None


def decode_rows(page_table, positions, *, page_size: int) -> DecodeRows:
    """The step's half of the op's inputs: page_table (B, max_pages),
    positions (B,), each in [0, max_pages x page_size), on one device."""
    if page_table.dim() != 2 or positions.dim() != 1 \
            or page_table.shape[0] != positions.shape[0]:
        raise ValueError(f"page_table {tuple(page_table.shape)} / positions "
                         f"{tuple(positions.shape)}: want (B, max_pages) and "
                         f"(B,)")
    if page_size < 1:
        raise ValueError(f"page_size={page_size} must be >= 1")
    device = page_table.device
    if positions.device != device:
        raise ValueError("page_table and positions must sit on one device")
    if device.type != "cuda":
        return DecodeRows(page_table, positions, page_size, device)
    current = device.index == torch.cuda.current_device()
    return DecodeRows(page_table.long().contiguous(),
                      positions.long().contiguous(), page_size, device,
                      torch.cuda.current_stream(device).cuda_stream,
                      _CURRENT if current else torch.cuda.device(device))


def paged_decode_attention(q, pool_k, pool_v, page_table, positions, *,
                           page_size: int, window: int | None = None,
                           softcap: float | None = None, q2slot=None,
                           rows: DecodeRows | None = None):
    """q (B, Hq, hd) of one decode token a row; pools (num_pages,
    page_size, Hkv, hd); page_table (B, max_pages) physical page ids;
    positions (B,), each in [0, max_pages x page_size) -> (B, Hq, hd)
    f32.  Row b attends over its positions [pos - window + 1, pos] (all
    up to pos without a window); q head h reads stored head h / (Hq /
    Hkv), or `q2slot[h]` (the replicated-KV plan).  `rows`, the step's
    `decode_rows(page_table, positions, page_size=page_size)`, spares each
    layer of a step its conversions and checks; without it the call makes
    its own."""
    if rows is None:
        rows = decode_rows(page_table, positions, page_size=page_size)
    key = (q.shape, q.dtype, q.device, pool_k.shape, pool_k.dtype,
           pool_k.device, pool_v.shape, pool_v.dtype, pool_v.device,
           page_size, window, softcap,
           None if q2slot is None else (q2slot.shape, q2slot.device))
    if key != rows.checked:
        _check(q, pool_k, pool_v, rows.table, rows.positions, q2slot)
        if pool_k.shape[1] != page_size or rows.page_size != page_size:
            raise ValueError(f"pool pages of {pool_k.shape[1]} rows, "
                             f"page_size {page_size}")
        if window is not None and window < 1:
            raise ValueError(f"window={window} must be >= 1")
        if softcap is not None and softcap <= 0:
            raise ValueError(f"softcap={softcap} must be > 0")
        if q.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no kernel for device {q.device}")
        tensors = (q, pool_k, pool_v) + (() if q2slot is None else (q2slot,))
        if any(t.device != rows.device for t in tensors):
            raise ValueError("all tensors must be on one device")
        rows.checked = key
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("the pools must be contiguous")
    if q.device.type == "cpu":
        return ref.paged_decode_ref(q, pool_k, pool_v, page_table, positions,
                                    page_size=page_size, window=window,
                                    softcap=softcap, q2slot=q2slot)
    q = q.contiguous()
    if (q.data_ptr() | pool_k.data_ptr() | pool_v.data_ptr()) % 16:
        raise ValueError("q and the pools must be 16-byte aligned")
    if q2slot is not None:
        q2slot = q2slot.long().contiguous()
    b, hq, hd = q.shape
    n_out = b * hq * hd
    n_acc = n_out * rows.splits
    # one buffer: the output, then the splits' acc (.., hd) and (m, l)
    buf = torch.empty(n_out + n_acc + 2 * b * hq * rows.splits,
                      dtype=torch.float32, device=q.device)
    out = buf[:n_out].view(b, hq, hd)
    lib = _library()
    with rows.on_device:
        err = lib.repro_paged_decode(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            rows.table.data_ptr(), rows.positions.data_ptr(),
            None if q2slot is None else q2slot.data_ptr(),
            buf.data_ptr() + 4 * n_out, buf.data_ptr() + 4 * (n_out + n_acc),
            out.data_ptr(), _DTYPES[pool_k.dtype], _DTYPES[q.dtype], b, hq,
            pool_k.shape[2], hd, page_size, rows.table.shape[1],
            rows.split_pages, window or 0, float(softcap or 0.0),
            rows.stream)
    if err:
        raise RuntimeError("paged_decode launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    global launches
    launches += 1
    return out
