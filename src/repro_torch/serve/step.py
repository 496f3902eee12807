"""Serve-step builders (batched prefill, single-token decode over the
dense decode cache) and greedy sampling over (vocab-sharded) logits.

The builders compute no gradient.  The tuner and the profiler ride on
the `Comm` they build, as the reference's; the topology, link model and
mesh embedding knobs come with the multi-device backend (slice 5) and
raise here.  Its `allreduce_algo` picks among allreduce algorithms, all
the identity on one device: the port's `Comm` has none."""
from __future__ import annotations

import torch

from ..models import transformer
from ..models.config import ModelConfig
from ..parallel.comm import AxisSpec, Comm


def _refuse_unported(**knobs):
    unported = sorted(k for k, v in knobs.items() if v is not None)
    if unported:
        raise NotImplementedError(f"{unported}: not ported yet (slice 5)")


def build_prefill(cfg: ModelConfig, axes: AxisSpec = AxisSpec(),
                  backend: str = "shmem", *, topo=None, link=None,
                  embedding=None, tuner=None, profile=None):
    """fn(params, batch) -> last-position logits (B, 1, vocab_local) of
    batch["tokens"] (B, L), or of the audio frontend's batch["frames"]
    (B, L, d); the vision frontend's batch["frontend_embeds"] (B, nf, d)
    pass through to `transformer.prefill`.  Runs under
    `torch.no_grad()`."""
    _refuse_unported(topo=topo, link=link, embedding=embedding)

    @torch.no_grad()
    def fn(params, batch):
        return transformer.prefill(
            Comm(axes, backend, tuner=tuner, profile=profile), cfg, params,
            batch.get("tokens"), frames=batch.get("frames"),
            frontend_embeds=batch.get("frontend_embeds"))
    return fn


def build_decode_step(cfg: ModelConfig, axes: AxisSpec = AxisSpec(),
                      backend: str = "shmem", seq_shards: int = 1, *,
                      topo=None, link=None, embedding=None, tuner=None,
                      profile=None):
    """fn(params, cache, batch) -> (logits (B, 1, vocab_local), new cache)
    for batch {"tokens": (B, 1), "positions": (B,)}, under
    `torch.no_grad()`."""
    _refuse_unported(topo=topo, link=link, embedding=embedding)
    if seq_shards != 1:
        raise NotImplementedError("sequence-sharded decode comes with the "
                                  "multi-device backend (slice 5)")

    @torch.no_grad()
    def fn(params, cache, batch):
        return transformer.decode_step(Comm(axes, backend, tuner=tuner,
                                            profile=profile), cfg, params,
                                       cache, batch["tokens"],
                                       batch["positions"])
    return fn


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
