"""Parameter trees between the JAX package's layout and the port's."""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .transformer import _check_family, map_params


def params_from_jax(tree, cfg: ModelConfig, device="cpu"):
    """`tree` is the tree of `repro.models.transformer.init_params` (tp =
    1, any family) with every leaf already a numpy array: per-layer leaves
    stacked to [n_layers, ...] under "layers" (dense, audio and vlm:
    {"attn", "mlp", "ln1", "ln2"}; ssm and hybrid:
    {"mamba": {w_in, conv_w, conv_b, a_log, dt_bias, d_skip, norm_w,
    w_out}, "ln"}), and for the hybrid family the one shared block,
    unstacked, under "shared_attn" ({"attn", "mlp", "ln1", "ln2"}).
    gemma2's local/global pairs come as {"pairs": {"local", "global"}},
    each leaf stacked to [n_layers / 2, ...]: pair i is the port's layer
    2i (local), then 2i + 1 (global).  The moe family stacks its first
    `first_dense_layers` blocks under "dense_layers" and the MoE blocks
    ({"attn", "moe", "ln1", "ln2"}) under "layers"; its MTP head, under
    "mtp" ({"proj", "block": one dense block, "ln"}), is unstacked.
    Returns the port's parameters on `device`: one dict per layer, leaves
    of two or more dims in `cfg.param_dtype`, the rest in f32."""
    _check_family(cfg)
    device = torch.device(device)

    def leaf(a):
        t = torch.tensor(np.asarray(a, np.float32), device=device)
        return t.to(cfg.param_dtype) if t.dim() >= 2 else t

    def unstack(stack, n):
        def pick(j):
            def one(a):
                if a.shape[0] != n:
                    raise ValueError(f"stacked leaf of shape {a.shape} has "
                                     f"no leading dim of {n} layers")
                return a[j]
            return one
        return [map_params(leaf, map_params(pick(j), stack))
                for j in range(n)]

    out = {"embed": map_params(leaf, tree["embed"]),
           "final_norm": leaf(tree["final_norm"])}
    if cfg.local_global_period is not None:
        half = cfg.n_layers // 2
        pairs = zip(unstack(tree["pairs"]["local"], half),
                    unstack(tree["pairs"]["global"], half))
        out["layers"] = [blk for pair in pairs for blk in pair]
    elif cfg.family == "moe":
        nd = cfg.moe.first_dense_layers
        if nd:
            out["dense_layers"] = unstack(tree["dense_layers"], nd)
        out["layers"] = unstack(tree["layers"], cfg.n_layers - nd)
        if cfg.mtp:
            out["mtp"] = map_params(leaf, tree["mtp"])
    else:
        out["layers"] = unstack(tree["layers"], cfg.n_layers)
    if cfg.family == "hybrid":
        out["shared_attn"] = map_params(leaf, tree["shared_attn"])
    return out


def params_to_jax(params, cfg: ModelConfig):
    """The inverse of `params_from_jax`: the port's tree (parameters, or
    gradients of the same structure) as numpy arrays in the JAX package's
    layout, per-layer leaves stacked to [n, ...] under "layers" (and the
    moe family's "dense_layers"; gemma2: the even layers stacked under
    pairs/local, the odd ones under pairs/global), the hybrid family's
    shared block and the MTP head unstacked."""
    _check_family(cfg)

    def leaf(t):
        return t.detach().float().cpu().numpy()

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([l[k] for l in layers]) for k in first}
        return np.stack([leaf(t) for t in layers])

    out = {"embed": map_params(leaf, params["embed"]),
           "final_norm": leaf(params["final_norm"])}
    if cfg.local_global_period is not None:
        out["pairs"] = {"local": stack(params["layers"][0::2]),
                        "global": stack(params["layers"][1::2])}
    else:
        out["layers"] = stack(params["layers"])
    if "dense_layers" in params:
        out["dense_layers"] = stack(params["dense_layers"])
    for key in ("shared_attn", "mtp"):
        if key in params:
            out[key] = map_params(leaf, params[key])
    return out
