"""Greedy sampling over (vocab-sharded) logits."""
from __future__ import annotations

import torch

from ..parallel.comm import Comm


def sample_greedy(comm: Comm, logits):
    """logits (..., V_local) -> (...) int64 global token ids.

    Ties break to the LOWEST global index: each shard takes the lowest
    index of its local max, shards whose local max is below the global max
    offer an off-the-end sentinel, and a min-reduce picks the smallest
    global index among the tied shards."""
    v_local = logits.shape[-1]
    n = comm.axis_size(comm.axes.model)
    base = comm.axis_index(comm.axes.model) * v_local
    loc_max = logits.amax(-1)
    ids = torch.arange(v_local, device=logits.device)
    loc_arg = torch.where(logits == loc_max[..., None], ids,
                          v_local).amin(-1) + base
    g_max = comm.allreduce(loc_max, comm.axes.model, "max")
    winner = torch.where(loc_max >= g_max, loc_arg,
                         torch.full_like(loc_arg, n * v_local))
    return comm.allreduce(winner, comm.axes.model, "min")
