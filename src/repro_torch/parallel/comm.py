"""Comm — the collective surface the model code calls, for one device.

Counterpart of `repro/parallel/comm.py`.  The model functions take a Comm
and call its collectives at the same places as in `repro`, so the
multi-device backend can slot in later.  With one device every axis has
size 1: `axis_index` is 0 and the collectives are the identity.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """Mesh axis names by role (model = tensor parallel, data, pod)."""
    data: str | tuple[str, ...] = "data"
    model: str | tuple[str, ...] | None = "model"
    pod: str | None = None


class Comm:
    """Collectives over a one-device mesh."""

    def __init__(self, axes: AxisSpec = AxisSpec(), n_devices: int = 1):
        if n_devices != 1:
            raise NotImplementedError(
                "the port runs on one device; the multi-device backend is "
                "not ported yet")
        self.axes = axes

    def axis_size(self, axis) -> int:
        return 1

    def axis_index(self, axis) -> int:
        return 0

    def allreduce(self, x, axis, op: str = "sum"):
        return x

    def allgather(self, x, axis, *, concat_axis: int = 0):
        return x
