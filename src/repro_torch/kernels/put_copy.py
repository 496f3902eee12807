"""put_copy and dma_copy: the launching wrappers of csrc/put_copy.cu.

`put_copy` replaces the TPU kernel `repro/kernels/put_copy.py::put_copy_2d`
(the paper's shmem_put copy loop) and generalises it to a row table:
output row i is source row ``rows[i]``, zeros where that is -1.  One call
is one SIM delivery (`core/netops.SimNetOps.ppermute`).

`dma_copy` replaces `repro/kernels/put_copy.py::dma_copy_2d` (the e-DMA
engine's 2D strides) and generalises it to a batch of descriptors
(`DmaPlan`), all in one launch: the block gathers of the ring collectives
(`core/collectives._take_blocks`).

Both are bound by bytes: each byte read once and written once (the CUDA
source describes the design).  A CPU tensor goes to the plain version
(`ref.put_copy_ref`, `ref.dma_copy_ref`); a CUDA tensor launches the
kernel or raises; a meta tensor takes the meta path (`_meta`: the bytes
moved, read and written).  `launches` counts put_copy launches,
`dma_launches` dma_copy launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, _meta, ref

SEG_BYTES = 16 * 1024    # bytes per work item (kSeg in the CUDA source)

launches = 0
dma_launches = 0


def row_stride(t: torch.Tensor) -> int | None:
    """Elements between consecutive rows (``t[i]``) of `t` when every row
    is contiguous in memory and rows do not overlap, else None."""
    if t.dim() == 0:
        return None
    length = 1
    for size, st in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and st != length:
            return None
        length *= size
    if t.shape[0] <= 1:
        return length
    return t.stride(0) if t.stride(0) >= length else None


def _library() -> ctypes.CDLL:
    lib = _build.load("put_copy")
    if lib.repro_put_copy.argtypes is None:
        lib.repro_put_copy.argtypes = ([ctypes.c_void_p] * 3
                                       + [ctypes.c_int64] * 3
                                       + [ctypes.c_void_p])
        lib.repro_put_copy.restype = ctypes.c_int
        lib.repro_dma_copy.argtypes = ([ctypes.c_void_p] * 3
                                       + [ctypes.c_int64] * 5
                                       + [ctypes.c_void_p])
        lib.repro_dma_copy.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.repro_cuda_error_string(err).decode())


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if any(t.device != dev for t in ts):
        raise ValueError("all tensors must be on one device")


def put_copy(src: torch.Tensor, rows: torch.Tensor | None = None
             ) -> torch.Tensor:
    """Rows of `src` (dim 0 is the row axis) into a new contiguous tensor:
    output row i is ``src[rows[i]]``, zeros where ``rows[i]`` is -1;
    ``rows=None`` copies every row in place order.  `rows` is an int32
    tensor on src's device with entries in [-1, len(src))."""
    if src.dim() == 0:
        raise ValueError("put_copy needs a row axis (dim 0)")
    if rows is not None:
        if rows.dtype != torch.int32 or rows.dim() != 1:
            raise TypeError("rows must be a 1-D int32 tensor")
        if rows.device != src.device:
            raise ValueError(f"rows on {rows.device}, src on {src.device}")
    global launches
    if src.device.type == "cpu":
        return ref.put_copy_ref(src, rows)
    if src.device.type != "meta":
        _check_cuda(src)
    n_out = src.shape[0] if rows is None else rows.shape[0]
    out = torch.empty((n_out,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    row_bytes = (src[0].numel() if src.shape[0] else 0) * src.element_size()
    if n_out == 0 or row_bytes == 0:
        return out                      # nothing to move: no launch
    if src.device.type == "meta":
        _meta.note("put_copy", 0, 2 * n_out * row_bytes)
        launches += 1
        return out
    stride = row_stride(src)
    if stride is None:
        src = src.contiguous()
        stride = row_stride(src)
    lib = _library()
    with torch.cuda.device(src.device):
        err = lib.repro_put_copy(
            src.data_ptr(), out.data_ptr(),
            None if rows is None else rows.data_ptr(), n_out, row_bytes,
            stride * src.element_size(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "put_copy")
    launches += 1
    return out


def dma_copy_meta(nbytes: int) -> None:
    """The meta path of one `dma_copy` launch moving `nbytes`: the launch
    counted, its bytes read and written noted (`_meta`).  A meta rank's
    heap rounds (`core.netops.MetaNetOps`) count their byte copies here
    without building the tensors."""
    global dma_launches
    _meta.note("dma_copy", 0, 2 * nbytes)
    dma_launches += 1


class DmaPlan:
    """A batch of 2D copy descriptors between a (src_rows, src_cols) and a
    (dst_rows, dst_cols) element array: row q of `descs` is
    ``(sr, sc, dr, dc, nr, nc)``, moving ``src[sr:sr+nr, sc:sc+nc]`` to
    ``dst[dr:dr+nr, dc:dc+nc]``.  Bounds are checked once, here, on the
    host; the device copy of the table is cached per device."""

    def __init__(self, descs, src_shape, dst_shape):
        d = np.ascontiguousarray(np.asarray(descs, dtype=np.int64)
                                 .reshape(-1, 6))
        sr, sc, dr, dc, nr, nc = d.T
        (s_rows, s_cols), (d_rows, d_cols) = src_shape, dst_shape
        if len(d) == 0 or (d < 0).any() or (nr == 0).any() or \
                (nc == 0).any():
            raise ValueError("descriptors must be non-negative with "
                             "non-empty regions")
        if (sr + nr > s_rows).any() or (sc + nc > s_cols).any():
            raise ValueError(f"a region leaves the source {src_shape}")
        if (dr + nr > d_rows).any() or (dc + nc > d_cols).any():
            raise ValueError(f"a region leaves the destination {dst_shape}")
        d.setflags(write=False)
        self.descs = d
        self.src_shape = tuple(src_shape)
        self.dst_shape = tuple(dst_shape)
        self._device: dict[torch.device, torch.Tensor] = {}

    def __len__(self) -> int:
        return len(self.descs)

    def on(self, device: torch.device) -> torch.Tensor:
        got = self._device.get(device)
        if got is None:
            got = self._device[device] = torch.tensor(self.descs,
                                                      device=device)
        return got


def dma_copy(src: torch.Tensor, dst: torch.Tensor, plan: DmaPlan
             ) -> torch.Tensor:
    """Run every descriptor of `plan` from 2D `src` into 2D `dst`, IN
    PLACE (the rest of dst keeps its values); returns dst.  Both arrays
    need contiguous rows; src and dst must not overlap."""
    if tuple(src.shape) != plan.src_shape or \
            tuple(dst.shape) != plan.dst_shape:
        raise ValueError(f"plan for {plan.src_shape} -> {plan.dst_shape}, "
                         f"got {tuple(src.shape)} -> {tuple(dst.shape)}")
    if src.dtype != dst.dtype:
        raise TypeError(f"dtypes differ: {src.dtype} vs {dst.dtype}")
    global dma_launches
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return ref.dma_copy_ref(src, dst, plan.descs)
    if src.device.type == "meta" and dst.device.type == "meta":
        dma_copy_meta(int((plan.descs[:, 4] * plan.descs[:, 5]).sum())
                      * src.element_size())
        return dst
    _check_cuda(src, dst)
    s_ld, d_ld = row_stride(src), row_stride(dst)
    if s_ld is None:
        src = src.contiguous()
        s_ld = row_stride(src)
    if d_ld is None:
        raise ValueError("dst needs contiguous rows (it is written in place)")
    if src.untyped_storage().data_ptr() == dst.untyped_storage().data_ptr():
        raise ValueError("src and dst share storage")
    elem = src.element_size()
    segs = -(-(plan.descs[:, 5] * elem) // SEG_BYTES)
    max_items = int((plan.descs[:, 4] * segs).max())
    lib = _library()
    with torch.cuda.device(src.device):
        err = lib.repro_dma_copy(
            src.data_ptr(), dst.data_ptr(), plan.on(src.device).data_ptr(),
            len(plan), max_items, elem, s_ld, d_ld,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "dma_copy")
    dma_launches += 1
    return dst
