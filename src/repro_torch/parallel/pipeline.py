"""Pipeline parallelism over the pod axis: a GPipe schedule on the
paper's puts (port of `repro/parallel/pipeline.py`).

Stages are pods, so the slow links between pods carry only the
stage-boundary activations, one microbatch a tick.  Stage `s` holds
layers [s L/P, (s + 1) L/P) of the stack (`sharding.pipeline_stage` cuts
the port's layer list where the reference shards its stacked dim over
`pod`); every stage runs the same code on its layers, and microbatches
move stage to stage by `Comm.ppermute` over `pod`.  Autograd reverses the
schedule: the delivery's backward (`core/netops._Deliver`) sends each
activation's cotangent back to the stage that produced it.

Every rank issues every collective of the schedule in the same order
(an SPMD heap round is a barrier over all ranks): stage selection is by
`torch.where` on the stage's flags, never by a Python branch on the
stage, so each stage embeds, runs the LM head and the sharded loss, and
puts, every tick, as the reference's `jnp.where`s compute both sides.

Scope, as the reference's: the dense, audio and vlm stacks without
gemma2's local/global pairs.
"""
from __future__ import annotations

import torch

from ..models import layers as L
from ..models import transformer
from ..models.config import ModelConfig
from .comm import Comm


def supported(cfg: ModelConfig) -> bool:
    return cfg.family in ("dense", "vlm", "audio") \
        and not cfg.local_global_period


def pipeline_train_loss(comm: Comm, cfg: ModelConfig, params, batch, *,
                        pp_axis: str = "pod", n_micro: int | None = None):
    """GPipe forward + loss over `pp_axis`: ``params["layers"]`` is this
    stage's list of L/P layer dicts (`sharding.pipeline_stage`); the
    other leaves are whole on every stage.  `batch` is the whole batch on
    every stage ({"tokens" or "frames", "targets"}, (B, L)), cut into
    `n_micro` microbatches (default: the stage count).  Over n_micro + P
    - 1 ticks stage 0 injects microbatch t (its token embedding, or the
    audio frontend's frames cast to cfg.dtype; the vision frontend's
    embeds are not read, as in the reference), every stage runs its
    layers (`transformer._maybe_remat` of `_attn_block`) and then the
    final norm, the LM head and `sharded_xent` on its output, of which
    only the last stage's ticks t >= P - 1 count, and puts its output to
    the next stage.  Returns the token mean, the loss sum over the int32
    token count, each allreduced over `pp_axis`: on every stage alike,
    `transformer.train_loss` of the batch up to the microbatch
    boundaries."""
    P = comm.axis_size(pp_axis)
    stage = comm.axis_index(pp_axis)
    tokens = batch.get("tokens")
    frames = batch.get("frames")
    targets = batch["targets"]
    B, seq = targets.shape[0], targets.shape[1]
    n_micro = n_micro or max(P, 1)
    if B % n_micro:
        raise ValueError(f"a batch of {B} does not split into {n_micro} "
                         f"microbatches")
    mb = B // n_micro
    dev = targets.device
    positions = torch.arange(seq, device=dev).expand(mb, seq)
    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == P - 1, device=dev)

    def embed_micro(i):
        rows = slice(i * mb, (i + 1) * mb)
        if cfg.frontend == "audio":
            return frames[rows].to(cfg.dtype)
        return transformer._embed_scaled(comm, cfg, params, tokens[rows])

    def my_layers(x):
        for bp in params["layers"]:
            x, _ = transformer._maybe_remat(
                cfg, lambda x, bp=bp: transformer._attn_block(
                    comm, cfg, bp, x, positions))(x)
        return x

    fwd_perm = [(s, s + 1) for s in range(P - 1)]
    x_in = torch.zeros((mb, seq, cfg.d_model), dtype=cfg.dtype, device=dev)
    loss_sum = torch.zeros((), device=dev)
    tok_count = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(n_micro + P - 1):
        # stage 0 injects microbatch t (zeros once drained)
        x0 = torch.where(first & (t < n_micro),
                         embed_micro(min(t, n_micro - 1)), x_in)
        y = my_layers(x0)
        # the last stage finalizes microbatch m = t - (P - 1)
        m = t - (P - 1)
        keep = last & (0 <= m < n_micro)
        h = L.rms_norm(y, params["final_norm"])
        logits = L.lm_logits(comm, cfg, params["embed"], h)
        lo = min(max(m, 0), n_micro - 1) * mb
        tok_loss = L.sharded_xent(comm, cfg, logits, targets[lo:lo + mb])
        loss_sum = loss_sum + torch.where(keep, tok_loss.sum(), 0.0)
        tok_count = tok_count + keep.int() * tok_loss.numel()
        # ship the activations to the next stage (the paper's put)
        x_in = comm.ppermute(y, pp_axis, fwd_perm) if P > 1 else y
    # the loss lives on the last stage: share it over the stages
    total = comm.allreduce(loss_sum, pp_axis)
    count = comm.allreduce(tok_count, pp_axis)
    return total / count.clamp_min(1)
