"""The rank mesh: the named axes of the rank processes (port of
`repro/launch/mesh.py`).

The reference's `make_mesh` lays devices out on named axes for shard_map;
here each PE is a rank process of `core.spmd.run`, and the mesh says
where this rank sits: its coordinates on each axis, and for an axis (or a
tuple of axes, flattened row-major as shard_map flattens them) the group
of ranks that share every other coordinate — the PE space a collective
over that axis runs in.  `AxisSpec` names (parallel/comm.py) resolve
against it.  Ranks are laid out row-major over the axes, as
`jax.make_mesh` lays out devices.  `make_production_mesh` gives the
reference's 16x16 and 2x16x16 production meshes as shapes only.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import spmd


def _axes(axis) -> tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """`shape` ranks named `axis_names`, seen from rank `rank`."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{self.axis_names} vs shape {self.shape}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.size}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def coords(self) -> dict[str, int]:
        """This rank's index on each axis."""
        return dict(zip(self.axis_names,
                        np.unravel_index(self.rank, self.shape)))

    def _check(self, axis) -> tuple[str, ...]:
        axs = _axes(axis)
        missing = [a for a in axs if a not in self.axis_names]
        if missing:
            raise ValueError(f"axis {missing} not in mesh {self.axis_names}")
        return axs

    def axis_size(self, axis) -> int:
        """The PE count of `axis` (a name or a tuple, flattened)."""
        return int(np.prod([self.sizes[a] for a in self._check(axis)]))

    def axis_index(self, axis) -> int:
        """This rank's PE id on `axis`: its coordinates there, row-major
        in the order the tuple names them."""
        axs = self._check(axis)
        c = self.coords
        return int(np.ravel_multi_index([c[a] for a in axs],
                                        [self.sizes[a] for a in axs]))

    def group(self, axis) -> tuple[int, ...]:
        """The world ranks of this rank's group over `axis`, in PE order:
        entry i is the rank whose PE id on `axis` is i and whose other
        coordinates are this rank's."""
        axs = self._check(axis)
        c = self.coords
        out = []
        for pe in range(self.axis_size(axs)):
            sub = np.unravel_index(pe, [self.sizes[a] for a in axs])
            cc = dict(c)
            cc.update(zip(axs, (int(i) for i in sub)))
            out.append(int(np.ravel_multi_index(
                [cc[a] for a in self.axis_names], self.shape)))
        return tuple(out)


def make_rank_mesh(shape, axis_names) -> RankMesh:
    """The mesh of this rank process over `shape` named `axis_names`;
    becomes the rank's current mesh (`core.spmd.current().mesh`).  The
    mesh must cover every rank of the run."""
    rt = spmd.current()
    mesh = RankMesh(tuple(axis_names), tuple(int(s) for s in shape),
                    rt.rank)
    if mesh.size != rt.world:
        raise ValueError(f"a mesh of {mesh.size} ranks over a run of "
                         f"{rt.world}")
    rt.mesh = mesh
    return mesh


def make_mesh(data: int, model: int, pod: int | None = None) -> RankMesh:
    """Any (pod,) data x model factorization of the run's ranks."""
    if pod:
        return make_rank_mesh((pod, data, model), ("pod", "data", "model"))
    return make_rank_mesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> RankMesh:
    """The 16x16 ("data", "model") mesh of one pod (256 ranks), or the
    2x16x16 ("pod", "data", "model") mesh of two (512), seen from rank
    `rank`.  It spawns no process: it is a mesh shape, for the shapes and
    specs of a rank (`launch/build.py`) and for tracing one rank's step on
    the meta device (`core.spmd.meta_rank`, `launch/dryrun.py`)."""
    if multi_pod:
        return RankMesh(("pod", "data", "model"), (2, 16, 16), rank)
    return RankMesh(("data", "model"), (16, 16), rank)
