"""Sharding rules for parameters, decode caches and step inputs (port
of `repro/parallel/sharding.py` for tensor-, expert- and data-parallel
training and serving).

A spec is a tuple with one entry per dim of a leaf: None (replicated), an
axis name, or a tuple of axis names (the dim split over their flattened
PE space, row-major) — the reference's PartitionSpec as plain data.  The
port's parameter tree holds one dict per layer, so no spec carries the
reference's stacked-layer prefix.

  * TP dims follow the local sizing in models/layers.py (q heads, FFN
    hidden, vocab, SSM heads over `model`);
  * replicated-over-model leaves (KV projections when n_kv < tp or the
    heads do not divide tp, MLA latents, routers, norms) get None there;
  * MoE expert leaves are sharded over the EP group: `model`, or the
    flattened (data, model) when `ep_over_data`;
  * decode caches (`cache_specs`) hold their batch over `data` and
    their kv heads, SSM heads and conv channels over `model`.

fsdp (ZeRO-3 over `data`) is slice 5c-3c and raises here.
"""
from __future__ import annotations

import dataclasses

from ..models import layers as L
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str | None = "model"   # None = dp_only (params replicated)
    pod: str | None = None


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.fsdp:
        raise NotImplementedError("fsdp comes with slice 5c-3c")


def _ep_over_data(cfg: ModelConfig) -> bool:
    return cfg.moe is not None and cfg.moe.ep_over_data


def _is_expert(path: tuple[str, ...]) -> bool:
    """A routed expert's weight (not the shared experts' MLP)."""
    return ("moe" in path and "shared" not in path
            and path[-1] in ("w_gate", "w_up", "w_down"))


def _base_spec(path: tuple[str, ...], leaf, cfg: ModelConfig, ax: MeshAxes,
               tp: int) -> tuple:
    """The spec of one leaf from its name (the last path entry)."""
    name = path[-1]
    nd = leaf.dim()
    if _is_expert(path):
        ep = (ax.data, ax.model) if _ep_over_data(cfg) else ax.model
        return (ep, None, None)
    if name == "router":
        return (None, None)
    if name in ("wq", "w_gate", "w_up", "wq_b", "wkv_b", "w_in", "conv_w"):
        return (None, ax.model)
    if name in ("wo", "w_down", "w_out"):
        return (ax.model, None)
    if name in ("wk", "wv"):
        # replicated when kv heads don't divide tp (gathered per q head)
        _, _, repl = L._gqa_dims(cfg, tp)
        return (None, None) if repl else (None, ax.model)
    if name in ("bk", "bv"):
        _, _, repl = L._gqa_dims(cfg, tp)
        return (None,) if repl else (ax.model,)
    if name in ("bq", "a_log", "dt_bias", "d_skip", "norm_w", "conv_b"):
        return (ax.model,)
    if name in ("wq_a", "wkv_a", "proj"):
        return (None, None)
    if name == "table":
        return (ax.model, None)
    if name == "head":
        return (None, ax.model)
    if name in ("q_norm", "kv_norm", "ln", "ln1", "ln2", "final_norm"):
        return (None,)
    if nd == 1:
        return (None,)
    raise ValueError(f"no sharding rule for param {'/'.join(path)}")


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(cfg: ModelConfig, params, ax: MeshAxes, tp: int):
    """The spec tree of `params` (the port's tree, any leaves with
    `.dim()`: tensors, or meta tensors for shapes only)."""
    _check_ported(cfg)
    return _map_path(lambda p, l: _base_spec(p, l, cfg, ax, tp), params)


def spec_leaves(params, specs) -> list[tuple]:
    """The specs of `params`' leaves in `core.heap.tree_flatten`'s order
    (dict keys sorted): a spec is a tuple, which tree_flatten would walk
    into."""
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in spec_leaves(params[k], specs[k])]
    if isinstance(params, (list, tuple)):
        return [x for p, s in zip(params, specs)
                for x in spec_leaves(p, s)]
    return [specs]


def needs_data_sync(cfg: ModelConfig, params):
    """Bool tree of `params`' structure: True where the gradient leaf is
    replicated over `data` and needs grad_sync.  The expert leaves under
    `ep_over_data` are sharded over `data` and arrive reduced over it
    (their gradients are not divided by the data size, as in the
    reference); fsdp is slice 5c-3c."""
    if cfg.fsdp:
        raise NotImplementedError("fsdp comes with slice 5c-3c")
    ep_data = _ep_over_data(cfg)
    return _map_path(lambda p, l: not (ep_data and _is_expert(p)), params)


def cache_specs(cfg: ModelConfig, cache, ax: MeshAxes, seq_shards: int = 1):
    """The spec tree of a decode cache (`transformer.init_cache`'s tree,
    one dict per layer): the batch over `data`; "k"/"v" (B, S, H, hd)
    their heads over `model`, "c_kv"/"k_rope" (B, S, r) replicated over
    it (MLA's latent cache), "conv" (B, w, channels) its channels and
    "ssm" (B, H, P, N) its heads over `model`.  With seq_shards > 1 the
    batch is replicated and the sequence dim S of "k", "v", "c_kv" and
    "k_rope" is over `data` instead; "conv" and "ssm" are replicated
    over it."""
    bd = ax.data if seq_shards == 1 else None
    sd = None if seq_shards == 1 else ax.data
    rules = {"k": (bd, sd, ax.model, None), "v": (bd, sd, ax.model, None),
             "c_kv": (bd, sd, None), "k_rope": (bd, sd, None),
             "conv": (bd, None, ax.model), "ssm": (bd, ax.model, None, None)}

    def one(path, leaf):
        if path[-1] not in rules:
            raise ValueError(f"no cache rule for {'/'.join(path)}")
        return rules[path[-1]]

    return _map_path(one, cache)


def batch_specs(cfg: ModelConfig, batch: dict, ax: MeshAxes, kind: str,
                seq_shards: int = 1) -> dict:
    """Input sharding: the global batch over (pod, data) — over data x
    model when `model` is None (dp_only).  Sequence-sharded caches
    (seq_shards > 1) replicate the batch instead."""
    ddims = (ax.data,) if ax.model is not None else (ax.data, "model")
    if ax.pod:
        ddims = (ax.pod,) + ddims
    bdim = None if seq_shards > 1 else \
        (ddims if len(ddims) > 1 else ddims[0])
    out = {}
    for k in batch:
        if k in ("tokens", "targets"):
            out[k] = (bdim, None)
        elif k == "positions":
            out[k] = (bdim,)
        elif k in ("frames", "frontend_embeds"):
            out[k] = (bdim, None, None)
        else:
            raise ValueError(k)
    return out
