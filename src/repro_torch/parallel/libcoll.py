"""The library collectives of `Comm(backend="xla")`: the vendor-library
baseline the paper holds its runtime against (eLib on the Epiphany, XLA's
collectives in the reference).

Inside a rank process of `core.spmd.run` each collective is one
`torch.distributed` call over the process group of its mesh axis
(`core.spmd.RankContext.axis_group`), with the semantics of the
reference's `lax` primitive:

  all_reduce      psum / pmax / pmin
  all_gather      all_gather(tiled=True) along `concat_axis`
  reduce_scatter  psum_scatter(tiled=True): PE i holds block i
  all_to_all      all_to_all(tiled=True): block j of `split_axis` goes to
                  PE j, the block from PE i lands at block i of
                  `concat_axis`

The library is gloo, the backend the rank runtime already starts for its
barriers.  NCCL cannot serve: every rank of a run shares the one card,
and NCCL refuses two ranks on one device ("Duplicate GPU detected").
Gloo takes CUDA tensors for all four collectives at bf16, f32 and int64
(torch 2.11 on the H100's host): it stages them through host memory
inside the call, so no branch here copies.  Each call waits on its work,
so the caller's stream sees the result, and adds its host time to the
rank's `lib_s` (`core.spmd.RankContext.lib_call`).

torch numbers a group's members by ascending world rank; blocks and
routes are mapped to PE ids through the group's `order` and `index`.

The sum collectives are differentiable, with the transposes the
reference gets under shard_map(check_vma=False): psum <-> psum,
all_gather <-> psum_scatter, all_to_all <-> the inverse all_to_all.
max and min carry no gradient (no path differentiates them).

In a meta rank (`core.spmd.meta_rank`) the tensors are meta tensors: a
call is not made but counted, by kind and its output's bytes
(`spmd.MetaRank.lib_call`), and returns its output's shape.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import spmd

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The `op` reduction of `x` over the group's PEs (a new tensor)."""
    if op not in _OPS:
        raise NotImplementedError(op)
    out = x.detach().contiguous().clone()
    flat = out.view(-1)
    spmd.current().lib_call(lambda: dist.all_reduce(
        flat, _OPS[op], group=group.pg, async_op=True).wait(),
        "all-reduce", _nbytes(out))
    return out


def all_gather(x: torch.Tensor, group, concat_axis: int = 0):
    """Every PE's `x`, concatenated along `concat_axis` in PE order."""
    x = x.detach().contiguous()
    buf = x.new_empty((group.size,) + tuple(x.shape))
    spmd.current().lib_call(lambda: dist.all_gather_into_tensor(
        buf.view(-1), x.view(-1), group=group.pg, async_op=True).wait(),
        "all-gather", _nbytes(buf))
    if not group.in_order:
        buf = buf[group.index]
    return torch.cat(buf.unbind(0), dim=concat_axis)


def _blocks(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """`x` cut into n blocks along `axis`: (n, block of axis moved to the
    front, the other dims)."""
    moved = x.movedim(axis, 0)
    if moved.shape[0] % n:
        raise ValueError(f"dim {axis} of size {moved.shape[0]} does not "
                         f"split over {n} PEs")
    return moved.reshape((n, moved.shape[0] // n) + tuple(moved.shape[1:]))


def reduce_scatter(x: torch.Tensor, group, scatter_axis: int = 0):
    """Block i (along `scatter_axis`) of the sum over the group, on PE
    i."""
    blocks = _blocks(x.detach(), group.size, scatter_axis)
    if not group.in_order:
        blocks = blocks[group.order]
    blocks = blocks.contiguous()
    out = blocks.new_empty(blocks.shape[1:])
    spmd.current().lib_call(lambda: dist.reduce_scatter_tensor(
        out.view(-1), blocks.view(-1), group=group.pg,
        async_op=True).wait(), "reduce-scatter", _nbytes(out))
    return out.movedim(0, scatter_axis)


def all_to_all(x: torch.Tensor, group, split_axis: int = 0,
               concat_axis: int = 0):
    """Block j of `split_axis` to PE j; the block from PE i at block i of
    `concat_axis`."""
    blocks = _blocks(x.detach(), group.size, split_axis)
    if not group.in_order:
        blocks = blocks[group.order]
    blocks = blocks.contiguous()
    got = torch.empty_like(blocks)
    spmd.current().lib_call(lambda: dist.all_to_all_single(
        got.view(-1), blocks.view(-1), group=group.pg,
        async_op=True).wait(), "all-to-all", _nbytes(got))
    if not group.in_order:
        got = got[group.index]
    return torch.cat([b.movedim(0, split_axis) for b in got.unbind(0)],
                     dim=concat_axis)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return reduce_scatter(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (all_to_all(g, ctx.group, concat_axis, split_axis), None,
                None, None)


def psum(x, group):
    """all_reduce sum, differentiable."""
    return _AllReduce.apply(x, group)


def gather(x, group, concat_axis: int = 0):
    """all_gather, differentiable."""
    return _AllGather.apply(x, group, concat_axis)


def psum_scatter(x, group, scatter_axis: int = 0):
    """reduce_scatter, differentiable."""
    return _ReduceScatter.apply(x, group, scatter_axis)


def exchange(x, group, split_axis: int = 0, concat_axis: int = 0):
    """all_to_all, differentiable."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)
