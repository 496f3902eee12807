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
  * cfg.fsdp (ZeRO-3) shards dim 0 of every 2-D block leaf but the
    embedding over `data` as well (`is_fsdp_leaf`): a rank holds 1/dp of
    its model shard's rows (`fsdp_localize`, `fsdp_shard_init`) and
    `models.transformer._fsdp_gather` gathers them inside each block;
  * decode caches (`cache_specs`) hold their batch over `data` and
    their kv heads, SSM heads and conv channels over `model`.

The specs mirror the reference's, whose per-layer leaves are stacked to
[n_layers, ...]: its fsdp test counts that stacked dim, so only the
unstacked 2-D leaves (the hybrid family's shared block, the MTP head)
carry `data` in their spec — `model` becomes the tuple (model, data),
model-major — while a per-layer leaf of "layers" or "dense_layers" is
localized and gathered all the same but its spec names `model` alone.
The GLOBAL tree the launcher gathers under these specs (its checkpoint)
therefore holds data rank 0's rows of the per-layer fsdp leaves, as the
reference's does.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import layers as L
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str | None = "model"   # None = dp_only (params replicated)
    pod: str | None = None


# the port's lists of per-layer dicts, which the reference stacks
_STACKED = ("layers", "dense_layers")


def _is_stacked(path: tuple[str, ...]) -> bool:
    return any(p in _STACKED for p in path[:-1])


def pipeline_stage(tree, stage: int, n_stages: int):
    """Stage `stage`'s part of a parameter tree (or its spec tree) for
    `parallel.pipeline`: under "layers" its L / n_stages consecutive
    layers [stage L/P, (stage + 1) L/P), every other leaf whole.  The
    port's cut of the reference's stacked dim sharded over `pod`."""
    layers = tree["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers do not split into "
                         f"{n_stages} pipeline stages")
    k = len(layers) // n_stages
    return dict(tree, layers=layers[stage * k:(stage + 1) * k])


def _ep_over_data(cfg: ModelConfig) -> bool:
    return cfg.moe is not None and cfg.moe.ep_over_data


def _is_expert(path: tuple[str, ...]) -> bool:
    """A routed expert's weight (not the shared experts' MLP)."""
    return ("moe" in path and "shared" not in path
            and path[-1] in ("w_gate", "w_up", "w_down"))


def _with_data(spec: tuple, ax: MeshAxes) -> tuple:
    """`spec` with `data` added to dim 0, after what it names there: the
    rows split model-major, so data splits within each model shard."""
    d0 = spec[0]
    if d0 is None:
        d0 = ax.data
    elif isinstance(d0, tuple):
        d0 = d0 + (ax.data,)
    else:
        d0 = (d0, ax.data)
    return (d0,) + tuple(spec[1:])


def _base_spec(path: tuple[str, ...], leaf, cfg: ModelConfig, ax: MeshAxes,
               tp: int) -> tuple:
    """The spec of one leaf from its name (the last path entry)."""
    name = path[-1]
    nd = leaf.dim()
    # the reference's rank of the leaf counts its stacked-layer dim
    fsdp0 = (cfg.fsdp and nd + int(_is_stacked(path)) == 2
             and "embed" not in path and name != "proj_mtp")

    def with_fsdp(dims):
        return _with_data(dims, ax) if fsdp0 else dims

    if _is_expert(path):
        ep = (ax.data, ax.model) if _ep_over_data(cfg) else ax.model
        return (ep, None, None)
    if name == "router":
        return with_fsdp((None, None))
    if name in ("wq", "w_gate", "w_up", "wq_b", "wkv_b", "w_in", "conv_w"):
        return with_fsdp((None, ax.model))
    if name in ("wo", "w_down", "w_out"):
        return with_fsdp((ax.model, None))
    if name in ("wk", "wv"):
        # replicated when kv heads don't divide tp (gathered per q head)
        _, _, repl = L._gqa_dims(cfg, tp)
        return with_fsdp((None, None) if repl else (None, ax.model))
    if name in ("bk", "bv"):
        _, _, repl = L._gqa_dims(cfg, tp)
        return (None,) if repl else (ax.model,)
    if name in ("bq", "a_log", "dt_bias", "d_skip", "norm_w", "conv_b"):
        return (ax.model,)
    if name in ("wq_a", "wkv_a", "proj"):
        return with_fsdp((None, None))
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
    return _map_path(lambda p, l: _base_spec(p, l, cfg, ax, tp), params)


def layout_specs(cfg: ModelConfig, params, ax: MeshAxes, tp: int):
    """The spec tree of the data-full GLOBAL tree's ZeRO-3 layout: every
    fsdp leaf's dim 0 over `data` too (model-major), stacked in the
    reference or not — which rows of the global tree each rank holds
    (`fsdp_shard_init`'s).  Without cfg.fsdp, `param_specs`."""
    plain = dataclasses.replace(cfg, fsdp=False)
    return _map_path(
        lambda p, l: (_with_data(_base_spec(p, l, plain, ax, tp), ax)
                      if is_fsdp_leaf(cfg, p, l.dim())
                      else _base_spec(p, l, plain, ax, tp)), params)


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


def is_fsdp_leaf(cfg: ModelConfig, path: tuple[str, ...], nd: int) -> bool:
    """The one fsdp predicate of the localization, the shard init and the
    gradient-sync mask (it must mirror `transformer._fsdp_gather`): a
    2-D leaf (per layer) outside the embedding."""
    return cfg.fsdp and nd == 2 and "embed" not in path


def fsdp_localize(cfg: ModelConfig, params, dp: int):
    """`init_params` makes model-local, data-full leaves; this gives the
    true per-rank shapes (meta tensors): dim 0 of every fsdp leaf divided
    by `dp`."""
    def one(path, leaf):
        if not is_fsdp_leaf(cfg, path, leaf.dim()):
            return leaf
        if leaf.shape[0] % dp:
            raise ValueError(f"{'/'.join(path)}: dim 0 of "
                             f"{tuple(leaf.shape)} does not split over "
                             f"{dp} data PEs")
        return torch.empty((leaf.shape[0] // dp,) + tuple(leaf.shape[1:]),
                           dtype=leaf.dtype, device="meta")
    return _map_path(one, params)


def fsdp_shard_init(cfg: ModelConfig, params, data_rank: int, dp: int):
    """Freshly made (data-full) fsdp leaves cut to this rank's rows: block
    `data_rank` of dim 0 (within the rank's model shard)."""
    def one(path, leaf):
        if not is_fsdp_leaf(cfg, path, leaf.dim()):
            return leaf
        size = leaf.shape[0] // dp
        return leaf.narrow(0, data_rank * size, size).contiguous()
    return _map_path(one, params)


def needs_data_sync(cfg: ModelConfig, params):
    """Bool tree of `params`' structure: True where the gradient leaf is
    replicated over `data` and needs grad_sync.  The expert leaves under
    `ep_over_data` are sharded over `data` and arrive reduced over it,
    and so do fsdp leaves (the gather's backward sums each block's
    cotangents over `data`): neither is divided by the data size, as in
    the reference."""
    ep_data = _ep_over_data(cfg)
    return _map_path(lambda p, l: not ((ep_data and _is_expert(p))
                                       or is_fsdp_leaf(cfg, p, l.dim())),
                     params)


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
