"""The kernels' meta paths: what a launch on the card would do, for
tensors on PyTorch's "meta" device (shapes and dtypes, no storage).

Given meta tensors, each wrapper counts the launch in its module's
`launches` exactly where its CUDA path counts it, notes here the
operations and bytes of the launch, and returns empty meta tensors of its
outputs' shapes and dtypes.  It never runs the plain version: that would
count work the kernel does not do (kernel 4's whole L x L logits).  The
counts are those of each kernel's bound on the card: every input byte
read once, every output byte written once, and the operations the data
needs (kernel 4's kept query-key pairs x 2(D + Dv) a head).

`launch/dryrun.py` resets `work` before a trace and reads it after.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# kernel name -> {"launches", "ops", "bytes"} since the last `reset`
work: dict = {}


def reset() -> None:
    work.clear()


def note(kernel: str, ops: int, nbytes: int) -> None:
    """One launch of `kernel` doing `ops` operations over `nbytes`."""
    w = work.setdefault(kernel, {"launches": 0, "ops": 0, "bytes": 0})
    w["launches"] += 1
    w["ops"] += int(ops)
    w["bytes"] += int(nbytes)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


@functools.lru_cache(maxsize=256)
def kept_pairs(lq: int, lk: int, causal: bool, window, lk_valid: int
               ) -> int:
    """Query-key pairs kernel 4's mask keeps: query row i (position i)
    reads keys j < lk_valid with j <= i when causal and j > i - window
    under a window."""
    i = np.arange(lq, dtype=np.int64)
    hi = np.full(lq, lk_valid - 1, dtype=np.int64)
    if causal:
        hi = np.minimum(hi, i)
    lo = np.zeros(lq, dtype=np.int64) if window is None \
        else np.maximum(0, i - window + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")
