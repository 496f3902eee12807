"""Comm: the collective surface the model code and the trainer call, for
one device.

Counterpart of `repro/parallel/comm.py`.  The model functions take a Comm
and call its collectives at the same places as in `repro`.  With one
device every axis has size 1: `axis_index` is 0 and the model-axis
collectives (allreduce, allgather, and the expert-parallel alltoall) are
the identity.  The gradient syncs run the SIM runtime's
collectives (`core/collectives.py`, `core/fusion.py`) on `SimNetOps(1)`,
each flat bucket viewed with a leading PE axis of one, so a one-device
train step goes through the same reduce-scatter / allgather / fused
AdamW code as a 16-PE SIM bucket.  The multi-device backend (SPMD over
torch.distributed) is slice 5.
"""
from __future__ import annotations

import dataclasses

from ..core import collectives as coll
from ..core import fusion
from ..core.netops import SimNetOps


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """Mesh axis names by role (model = tensor parallel, data, pod)."""
    data: str | tuple[str, ...] = "data"
    model: str | tuple[str, ...] | None = "model"
    pod: str | None = None

    def data_axes(self) -> tuple[str, ...]:
        return self.data if isinstance(self.data, tuple) else (self.data,)

    def grad_axes(self) -> tuple[str, ...]:
        """Axes over which gradients are averaged (pod x data)."""
        return ((self.pod,) if self.pod else ()) + self.data_axes()


class Comm:
    """Collectives over a one-device mesh.

    backend: "shmem" (the paper's runtime; "xla" is not ported);
    grad_rs: True runs gradient syncs as ring reduce-scatter + allgather
    instead of an allreduce.  The reference's `allreduce_algo` picks
    among allreduce algorithms, which on a one-PE data axis are all the
    identity; it comes with the multi-device backend (slice 5).  Until
    then `grad_rs` True and False also compute the same identity: the
    bucketed form is kept for that multi-PE data axis."""

    def __init__(self, axes: AxisSpec = AxisSpec(), backend: str = "shmem",
                 grad_rs: bool = False, n_devices: int = 1):
        if n_devices != 1:
            raise NotImplementedError(
                "the port runs on one device; the multi-device backend is "
                "not ported yet")
        if backend != "shmem":
            raise NotImplementedError(f"backend {backend!r}: only the shmem "
                                      f"backend is ported")
        self.axes = axes
        self.backend = backend
        self.grad_rs = grad_rs

    def _net(self, device) -> SimNetOps:
        """The data axis's one-PE SIM net on `device`."""
        return SimNetOps(1, device)

    def axis_size(self, axis) -> int:
        return 1

    def axis_index(self, axis) -> int:
        return 0

    def allreduce(self, x, axis, op: str = "sum"):
        return x

    def allgather(self, x, axis, *, concat_axis: int = 0):
        return x

    def alltoall(self, x, axis, *, split_axis: int = 0,
                 concat_axis: int = 0):
        """The MoE dispatch's exchange over `axis` (the expert-parallel
        group).  The shmem backend's alltoall is in place, so it splits
        and concatenates along one axis.  Every axis has size 1 here, so
        it is the identity; a SIM-backed expert-parallel dispatch over
        several PEs comes with the multi-device backend (slice 5)."""
        if axis is None or axis == ():
            return x
        if split_axis != concat_axis:
            raise ValueError("shmem alltoall is in-place ragged: "
                             "split_axis must equal concat_axis")
        return x

    def _scale(self) -> int:
        n = 1
        for a in self.axes.grad_axes():
            n *= self.axis_size(a)
        return n

    # -- gradient synchronization over the data axis -------------------------
    def grad_sync(self, grads, *, mean: bool = True):
        """Average each gradient tensor (a list, or one tensor) over the
        data axis: ring reduce-scatter + allgather with `grad_rs`, else
        the paper's allreduce."""
        def one(g):
            net = self._net(g.device)
            if self.grad_rs:
                own, info = coll.reduce_scatter(net, g[None], "sum")
                out = coll.allgather_unpad(net, own, info)[0]
            else:
                out = coll.allreduce(net, g[None], "sum")[0]
            return out / self._scale() if mean else out

        if isinstance(grads, (list, tuple)):
            return [one(g) for g in grads]
        return one(grads)

    def grad_sync_bucketed(self, buckets, *, mean: bool = True):
        """Ring reduce-scatter of every flat bucket, then the allgathers
        (two-phase issue, as the reference)."""
        owned = [coll.reduce_scatter(self._net(b.device), b[None], "sum")
                 for b in buckets]
        out = [coll.allgather_unpad(self._net(b.device), *own)[0]
               for b, own in zip(buckets, owned)]
        return [b / self._scale() for b in out] if mean else out

    def grad_sync_fused_update(self, g_bufs, p_bufs, moments, wd_masks,
                               c1, c2, *, lr: float, b1: float, b2: float,
                               eps: float, wd_coef: float, out_dtypes,
                               mean: bool = True):
        """grad_rs="fused": the bucketed ring reduce-scatter with the
        final combine of every bucket inside the combine + AdamW kernel
        (`core/fusion.fused_rs_adam`), then allgathers of the UPDATED
        param chunks at the param dtype.

        g_bufs/p_bufs: flat f32 gradient and param buckets; moments: per
        bucket {"m", "v"} OWNED chunks, shape (ceil(total/n),); wd_masks:
        per-bucket int8 weight-decay masks; c1/c2: ``1 - beta**t``;
        out_dtypes: per-bucket param dtypes.  Returns (updated full param
        buckets, updated moment chunks), bit for bit equal to
        grad_sync_bucketed then apply_updates (f32 moments)."""
        if self.axes.pod is not None:
            raise ValueError("grad_rs='fused' does not support a pod axis")
        scale = float(self._scale()) if mean else 1.0
        parts = [fusion.fused_rs_adam(
                     self._net(g.device), g[None], p[None], mv["m"][None],
                     mv["v"][None], w, c1, c2, lr=lr, b1=b1, b2=b2, eps=eps,
                     wd_coef=wd_coef, scale=scale, out_dtype=dt)
                 for g, p, mv, w, dt in zip(g_bufs, p_bufs, moments,
                                            wd_masks, out_dtypes)]
        outs = [coll.allgather_unpad(self._net(pc.device), pc, info)[0]
                for pc, _, _, info in parts]
        return outs, [{"m": m[0], "v": v[0]} for _, m, v, _ in parts]
