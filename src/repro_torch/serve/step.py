"""Serve-step builders (batched prefill, single-token decode over the
dense decode cache) and greedy sampling over (vocab-sharded) logits.

The builders compute no gradient.  As the reference's, they build the
step's `Comm` from the tuning knobs (`allreduce_algo`, `topo`, `link`,
`embedding`, `tuner`, `profile`), which steer its collectives over the
rank mesh of `core.spmd` when the step runs in a rank process; on one
device every axis has one PE and no collective consults them.  With
seq_shards > 1 the decode step runs the sequence-sharded caches over
`data` (the long-context decode): its softmax combines are allreduces
over that axis, through the same Comm."""
from __future__ import annotations

import torch

from ..models import transformer
from ..models.config import ModelConfig
from ..parallel.comm import AxisSpec, Comm


def build_prefill(cfg: ModelConfig, axes: AxisSpec = AxisSpec(),
                  backend: str = "shmem", *, allreduce_algo: str = "paper",
                  topo=None, link=None, embedding=None, tuner=None,
                  profile=None):
    """fn(params, batch) -> last-position logits (B, 1, vocab_local) of
    batch["tokens"] (B, L), or of the audio frontend's batch["frames"]
    (B, L, d); the vision frontend's batch["frontend_embeds"] (B, nf, d)
    pass through to `transformer.prefill`.  Runs under
    `torch.no_grad()`."""

    @torch.no_grad()
    def fn(params, batch):
        comm = Comm(axes, backend, allreduce_algo=allreduce_algo, topo=topo,
                    link=link, embedding=embedding, tuner=tuner,
                    profile=profile)
        return transformer.prefill(
            comm, cfg, params, batch.get("tokens"),
            frames=batch.get("frames"),
            frontend_embeds=batch.get("frontend_embeds"))
    return fn


def build_decode_step(cfg: ModelConfig, axes: AxisSpec = AxisSpec(),
                      backend: str = "shmem", seq_shards: int = 1, *,
                      allreduce_algo: str = "paper", topo=None, link=None,
                      embedding=None, tuner=None, profile=None):
    """fn(params, cache, batch) -> (logits (B, 1, vocab_local), new cache)
    for batch {"tokens": (B, 1), "positions": (B,)}, under
    `torch.no_grad()`; `seq_shards` > 1: the cache of
    `transformer.init_cache(seq_shards)`, its sequence over `data`."""

    @torch.no_grad()
    def fn(params, cache, batch):
        comm = Comm(axes, backend, allreduce_algo=allreduce_algo, topo=topo,
                    link=link, embedding=embedding, tuner=tuner,
                    profile=profile)
        return transformer.decode_step(comm, cfg, params, cache,
                                       batch["tokens"], batch["positions"],
                                       seq_shards=seq_shards)
    return fn


def sample_greedy(comm: Comm, logits):
    """logits (..., V_local) -> (...) int64 global token ids, the same on
    every PE of `model`.

    Ties break to the LOWEST global index: each shard takes the lowest
    index of its local max, shards whose local max is below the global
    max offer an off-the-end sentinel, and a min-reduce picks the
    smallest global index among the tied shards.  Over a model axis of
    more than one PE that is two allreduces: a max in the logits' dtype,
    then a min of int64 indices."""
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
