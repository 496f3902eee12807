"""Comm: the collective surface the model code and the trainer call.

Counterpart of `repro/parallel/comm.py`.  The model functions take a Comm
and call its collectives at the same places as in `repro`.  Axis roles:

  model  — tensor parallelism (activation allreduces, the vocab-sharded
           loss's reductions, the MoE expert alltoall)
  data   — data parallelism (the fused gradient buckets)
  pod    — cross-pod: gradients reduce within a pod over `data` first,
           then across pods (`grad_sync`, `grad_sync_bucketed`); the
           pipeline's stage-to-stage puts (`parallel/pipeline.py`)

Two backends, as the reference's substrate switch (`--comm shmem|xla`):

  shmem — the paper's runtime.  Inside a rank process of `core.spmd.run`
          whose mesh `launch.mesh` made, axis sizes and indices are read
          from that mesh and every collective runs the paper's
          algorithms (`core/collectives.py`, `core/fusion.py`) over the
          axis's `SpmdNetOps`: each PE's local tensor viewed with a
          leading PE row of one.  All collectives are differentiable
          (compositions of the SPMD ppermute Function, the block moves
          and the sum combine), so the manual-TP backward is the
          reversed communication schedule, as the reference gets it from
          the transpose of lax.ppermute.
  xla   — the vendor-library baseline (the reference's lax collectives):
          each collective is one torch.distributed call over the axis's
          process group (`parallel/libcoll.py`); the gradient sync is
          one allreduce over pod x data.  `ppermute` (the pipeline's
          stage puts) stays the heap round on both backends, as the
          reference's is lax.ppermute on both.

Outside a rank process the mesh is one device: every axis has size 1,
the collectives are the identity, and the bucketed gradient syncs of
shmem run on `SimNetOps(1)`; inside a rank process a Comm needs the rank
mesh and raises without one.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import collectives as coll
from ..core import fusion
from ..core import spmd
from ..core import team as team_mod
from ..core.netops import SimNetOps, SpmdNetOps, tree_map
from . import libcoll

_UNSET = object()


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """Mesh axis names by role (model = tensor parallel, data, pod); a
    tuple is flattened into one PE space.  model=None disables tensor
    parallelism."""
    data: str | tuple[str, ...] = "data"
    model: str | tuple[str, ...] | None = "model"
    pod: str | None = None

    def data_axes(self) -> tuple[str, ...]:
        return self.data if isinstance(self.data, tuple) else (self.data,)

    def grad_axes(self) -> tuple[str, ...]:
        """Axes over which gradients are averaged (pod x data)."""
        return ((self.pod,) if self.pod else ()) + self.data_axes()


class Comm:
    """Substrate-neutral collective surface used by models and training.

    backend: "shmem" (the paper's runtime) or "xla" (the library
    collectives, `parallel/libcoll.py`); the tuning knobs steer shmem's
    collectives only.
    tuning (as the reference's):
      allreduce_algo : "paper" (dissemination for pow2 / ring otherwise,
                       §3.6 verbatim), "auto" (cost-model selection on
                       `topo`; with a 2D+ topo it also prices the
                       hierarchical allreduce over the mesh's row teams),
                       "rd", "ring", "ring_emb" or "hier" (forced)
      topo           : MeshTopology the cost model prices hops against
                       (used only on an axis of its PE count)
      link           : alpha-beta LinkModel "auto" prices with
      grad_rs        : gradient syncs as ring reduce-scatter + allgather
                       instead of an allreduce
      pipeline_chunks: chunked double-buffered execution of allreduces
                       (int, "auto", None = monolithic; bit-identical)
      embedding      : mesh-embedded ring collectives (None, "auto",
                       "snake"; needs `topo`)
      tuner          : a core.tuner.Tuner or TunedSelector every "auto"
                       selection consults first
      profile        : a core.profile.Profiler noting the selections
    """

    def __init__(self, axes: AxisSpec = AxisSpec(), backend: str = "shmem",
                 allreduce_algo: str = "paper", grad_rs: bool = False,
                 topo=None, link=None, pipeline_chunks=None, embedding=None,
                 tuner=None, profile=None):
        if backend not in ("shmem", "xla"):
            raise ValueError(f"backend {backend!r}")
        if allreduce_algo not in ("paper", "auto", "rd", "ring", "ring_emb",
                                  "hier"):
            raise ValueError(f"allreduce_algo {allreduce_algo!r}")
        self.axes = axes
        self.backend = backend
        self.allreduce_algo = allreduce_algo
        self.grad_rs = grad_rs
        self.topo = topo
        self.link = link
        self.pipeline_chunks = pipeline_chunks
        self.embedding = embedding
        self.tuner = tuner
        self._sel = tuner.selector() if hasattr(tuner, "selector") else tuner
        self.profile = profile
        # the rank mesh inside a rank process, None on one device
        self.mesh = spmd.current().mesh if spmd.active() else None
        if spmd.active() and self.mesh is None:
            raise RuntimeError("Comm in a rank process with no rank mesh: "
                               "call launch.mesh.make_mesh (or "
                               "make_rank_mesh) in the rank first")
        self._nets: dict = {}
        self._partitions: dict = {}

    def _prof(self):
        p = self.profile
        return p if (p is not None and p.enabled) else None

    # -- helpers -------------------------------------------------------------
    def _net(self, axis, device):
        """The axis's net: its SpmdNetOps on a rank mesh, else the
        one-PE SIM net on `device`."""
        if self.mesh is None:
            return SimNetOps(1, device)
        key = axis
        got = self._nets.get(key)
        if got is None:
            got = self._nets[key] = SpmdNetOps(axis, self.mesh)
        return got

    def _group(self, axis):
        """The axis's library process group (an axis of more than one
        PE: so a rank process with its mesh)."""
        return spmd.current().axis_group(self.mesh, axis)

    def _topo_for(self, net):
        """The configured topology, only when it describes this axis's
        PE space."""
        if self.topo is not None and self.topo.n_pes == net.n_pes:
            return self.topo
        return None

    def _embedding_for(self, net):
        return self.embedding if self._topo_for(net) is not None else None

    def _partition_for(self, net):
        """The row-team partition of `topo` the hierarchical allreduce
        runs over, when the axis PE space is the topology's and it has a
        second dimension to split; None otherwise."""
        got = self._partitions.get(net.n_pes, _UNSET)
        if got is not _UNSET:
            return got
        part = None
        if (self.topo is not None and len(self.topo.shape) >= 2
                and self.topo.n_pes == net.n_pes):
            part = team_mod.split_2d(team_mod.team_world(net.n_pes),
                                     self.topo, axis=-1)
            if part.n_teams <= 1 or part.size <= 1:
                part = None
        self._partitions[net.n_pes] = part
        return part

    def axis_size(self, axis) -> int:
        if axis is None or axis == () or self.mesh is None:
            return 1
        return self.mesh.axis_size(axis)

    def axis_index(self, axis) -> int:
        if axis is None or axis == () or self.mesh is None:
            return 0
        return self.mesh.axis_index(axis)

    def _scale(self) -> int:
        n = 1
        for a in self.axes.grad_axes():
            n *= self.axis_size(a)
        return n

    # -- collectives ----------------------------------------------------------
    def allreduce(self, x, axis, op: str = "sum"):
        if self.axis_size(axis) == 1:
            return x
        if self.backend == "xla":
            group = self._group(axis)
            if op == "sum":
                return tree_map(lambda v: libcoll.psum(v, group), x)
            return tree_map(lambda v: libcoll.all_reduce(v, group, op), x)
        algo = None if self.allreduce_algo == "paper" else self.allreduce_algo

        def one(v):
            net = self._net(axis, v.device)
            part = self._partition_for(net) if algo in ("auto", "hier") \
                else None
            a = "auto" if algo == "hier" and part is None else algo
            return coll.allreduce(net, v[None], op, algorithm=a,
                                  topo=self._topo_for(net), link=self.link,
                                  pipeline_chunks=self.pipeline_chunks,
                                  partition=part,
                                  embedding=self._embedding_for(net),
                                  profile=self._prof(),
                                  tuner=self._sel)[0]

        return tree_map(one, x)

    def allgather(self, x, axis, *, concat_axis: int = 0):
        if self.axis_size(axis) == 1:
            return x
        if self.backend == "xla":
            return libcoll.gather(x, self._group(axis), concat_axis)
        net = self._net(axis, x.device)
        return coll.fcollect(net, x[None], axis=concat_axis,
                             topo=self._topo_for(net), link=self.link,
                             embedding=self._embedding_for(net),
                             profile=self._prof(), tuner=self._sel)[0]

    def reduce_scatter(self, x, axis, *, op: str = "sum",
                       scatter_axis: int = 0):
        """PE i gets block i of the `op`-reduction along `scatter_axis`
        (psum_scatter's layout)."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        if self.backend == "xla":
            if op != "sum":
                raise NotImplementedError(op)
            return libcoll.psum_scatter(x, self._group(axis), scatter_axis)
        net = self._net(axis, x.device)
        moved = x.movedim(scatter_axis, 0)
        if moved.shape[0] % n:
            raise ValueError(f"scatter dim {moved.shape[0]} not divisible "
                             f"by {n}")
        blk_shape = (moved.shape[0] // n,) + tuple(moved.shape[1:])
        own, _ = coll.reduce_scatter(net, moved[None], op)
        # the ring leaves PE p holding block (p+1)%n; one rotation ships
        # each block to its home PE
        home = net.ppermute(own, [(p, (p + 1) % n) for p in range(n)])
        return home[0].reshape(blk_shape).movedim(0, scatter_axis)

    def alltoall(self, x, axis, *, split_axis: int = 0,
                 concat_axis: int = 0):
        """The MoE dispatch's exchange over `axis` (a name, or a tuple
        flattened into one PE space): block j of `split_axis` goes to PE
        j, and the block from PE i lands at block i (the paper's pairwise
        exchange, `coll.alltoall`).  In place, so it splits and
        concatenates along one axis; the xla backend's (all_to_all,
        tiled) also along two.  Its gradient is the inverse exchange."""
        if axis is None or axis == ():
            return x
        if self.backend == "xla":
            if self.axis_size(axis) == 1:
                return x
            return libcoll.exchange(x, self._group(axis), split_axis,
                                    concat_axis)
        if split_axis != concat_axis:
            raise ValueError("shmem alltoall is in-place ragged: "
                             "split_axis must equal concat_axis")
        if self.axis_size(axis) == 1:
            return x
        return coll.alltoall(self._net(axis, x.device), x[None],
                             axis=split_axis, profile=self._prof(),
                             tuner=self._sel)[0]

    def broadcast(self, x, axis, root: int = 0):
        if self.axis_size(axis) == 1:
            return x
        if self.backend == "xla":
            # the reference's emulation: root's value, zeros elsewhere,
            # then the psum (values and gradient follow it; every rank
            # keeps `v` in its graph, so every rank runs the backward's
            # psum)
            keep = self.axis_index(axis) == root
            return self.allreduce(tree_map(lambda v: torch.where(
                torch.tensor(keep, device=v.device), v,
                torch.zeros_like(v)), x), axis)
        return coll.broadcast(self._net(axis, x.device), x[None], root,
                              profile=self._prof(), tuner=self._sel)[0]

    def ppermute(self, x, axis, perm):
        if self.axis_size(axis) == 1:
            return x
        return self._net(axis, x.device).ppermute(x[None], perm)[0]

    # -- gradient synchronization (hierarchical over pod x data) -------------
    def _pod_reduce(self, x):
        """The cross-pod allreduce after the data phase (none without a
        pod axis).  It runs over the pod axis's own net: a `topo` or
        embedding given for the data axis reaches it only through
        `_topo_for`, when it describes the pod's PE count."""
        if self.axes.pod is None:
            return x
        return self.allreduce(x, self.axes.pod)

    def grad_sync(self, grads, *, mean: bool = True):
        """Average each gradient tensor (a list, or one tensor) over the
        data (and pod) axes.  shmem: within a pod ring reduce-scatter +
        allgather with `grad_rs`, else the allreduce of `allreduce_algo`;
        then the allreduce across pods, as the reference's (fewest,
        largest messages on the slow links).  xla: one allreduce over the
        flattened pod x data group."""
        def one(g):
            if self.backend == "xla":
                out = self.allreduce(g, self.axes.grad_axes())
                return out / self._scale() if mean else out
            if self.grad_rs:
                net = self._net(self.axes.data, g.device)
                team = coll.embedding_team(self._embedding_for(net),
                                           self._topo_for(net), net.n_pes,
                                           self.link)
                own, info = coll.reduce_scatter(net, g[None], "sum",
                                                team=team)
                out = coll.allgather_unpad(net, own, info, team=team)[0]
            else:
                out = self.allreduce(g, self.axes.data)
            out = self._pod_reduce(out)
            return out / self._scale() if mean else out

        if isinstance(grads, (list, tuple)):
            return [one(g) for g in grads]
        return one(grads)

    def grad_sync_bucketed(self, buckets, *, mean: bool = True):
        """Ring reduce-scatter of every flat bucket, then the allgathers
        (two-phase issue, as the reference), over the data axis; with a
        pod axis each bucket is then allreduced across pods.  On a 2D+
        `topo` with allreduce_algo "auto"/"hier", a bucket whose
        hierarchical schedule prices below the flat ring runs
        `allreduce_hier`.  xla: one allreduce of each bucket over the
        flattened pod x data group."""
        if not buckets:
            return []
        if self.backend == "xla":
            out = [self.allreduce(b, self.axes.grad_axes()) for b in buckets]
            return [b / self._scale() for b in out] if mean else out
        net = self._net(self.axes.data, buckets[0].device)
        topo = self._topo_for(net)
        part = self._partition_for(net) \
            if self.allreduce_algo in ("auto", "hier") else None
        emb = self._embedding_for(net)
        team = coll.embedding_team(emb, topo, net.n_pes, self.link)

        def hier_wins(b) -> bool:
            if part is None:
                return False
            if self.allreduce_algo == "hier":
                return True
            nbytes = float(b.numel() * b.element_size())
            t_hier = coll.allreduce_hier_schedule(
                part, nbytes, topo=topo, link=self.link,
                embedding=emb).time(topo, self.link)
            t_flat = coll.allreduce_schedule(
                net.n_pes, nbytes, "ring_emb" if team is not None
                else "ring", embedding=None if team is None
                else team.members).time(topo, self.link)
            return t_hier < t_flat

        hier = [hier_wins(b) for b in buckets]
        owned = [None if h else coll.reduce_scatter(net, b[None], "sum",
                                                    team=team)
                 for b, h in zip(buckets, hier)]
        out = [coll.allreduce_hier(net, b[None], "sum", partition=part,
                                   topo=topo, link=self.link,
                                   embedding=emb)[0]
               if h else coll.allgather_unpad(net, *own, team=team)[0]
               for b, h, own in zip(buckets, hier, owned)]
        out = [self._pod_reduce(b) for b in out]
        return [b / self._scale() for b in out] if mean else out

    def grad_sync_fused_update(self, g_bufs, p_bufs, moments, wd_masks,
                               c1, c2, *, lr: float, b1: float, b2: float,
                               eps: float, wd_coef: float, out_dtypes,
                               mean: bool = True):
        """grad_rs="fused": the bucketed ring reduce-scatter with the
        final combine of every bucket inside the combine + AdamW kernel
        (`core/fusion.fused_rs_adam`: this PE's owned chunk through
        kernel 5), then allgathers of the UPDATED param chunks at the
        param dtype.

        g_bufs/p_bufs: flat f32 gradient and param buckets; moments: per
        bucket {"m", "v"} OWNED chunks, shape (ceil(total/n),); wd_masks:
        per-bucket int8 weight-decay masks; c1/c2: ``1 - beta**t``;
        out_dtypes: per-bucket param dtypes.  Returns (updated full param
        buckets, updated moment chunks), bit for bit equal to
        grad_sync_bucketed then apply_updates (f32 moments).  shmem only,
        as the reference's."""
        if self.backend != "shmem":
            raise ValueError("grad_rs='fused' runs on the shmem backend "
                             "only")
        if self.axes.pod is not None:
            raise ValueError("grad_rs='fused' does not support a pod axis")
        if not g_bufs:
            return [], []
        net = self._net(self.axes.data, g_bufs[0].device)
        team = coll.embedding_team(self._embedding_for(net),
                                   self._topo_for(net), net.n_pes, self.link)
        scale = float(self._scale()) if mean else 1.0
        parts = [fusion.fused_rs_adam(
                     net, g[None], p[None], mv["m"][None], mv["v"][None], w,
                     c1, c2, lr=lr, b1=b1, b2=b2, eps=eps, wd_coef=wd_coef,
                     scale=scale, out_dtype=dt, team=team,
                     profile=self._prof())
                 for g, p, mv, w, dt in zip(g_bufs, p_bufs, moments,
                                            wd_masks, out_dtypes)]
        outs = [coll.allgather_unpad(net, pc, info, team=team)[0]
                for pc, _, _, info in parts]
        return outs, [{"m": m[0], "v": v[0]} for _, m, v, _ in parts]
