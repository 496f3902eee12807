"""Parameter trees between the JAX package's layout and the port's, and
between a global tree and the local shards of each rank of a mesh."""
from __future__ import annotations

import dataclasses

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


# ---------------------------------------------------------------------------
# the rank mesh: global trees <-> each rank's local shards
# ---------------------------------------------------------------------------

def _spec_slices(spec, shape, sizes: dict, coords: dict):
    """The region of a global leaf of `shape` a rank at `coords` holds
    under `spec` (one entry per dim: None, an axis, or a tuple of axes
    flattened row-major): a list of (dim, start, length)."""
    out = []
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axs = ax if isinstance(ax, tuple) else (ax,)
        n = int(np.prod([sizes[a] for a in axs]))
        idx = int(np.ravel_multi_index([coords[a] for a in axs],
                                       [sizes[a] for a in axs]))
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {n} PEs")
        size = shape[dim] // n
        out.append((dim, idx * size, size))
    return out


def _specs(cfg: ModelConfig, params, tp: int):
    """The layout of the GLOBAL tree (`sharding.layout_specs`): with
    cfg.fsdp each fsdp leaf's rows split over data within each model
    shard; under `dp_only` nothing over `model` (tp 1)."""
    from ..parallel import sharding
    if cfg.shard_strategy == "dp_only":
        return sharding.layout_specs(cfg, params,
                                     sharding.MeshAxes(model=None), 1)
    return sharding.layout_specs(cfg, params, sharding.MeshAxes(), tp)


def _zip_specs(fn, tree, specs):
    """`fn(leaf, spec)` over a parameter tree and its spec tree (a spec is
    a tuple, so it is walked as a leaf)."""
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_specs(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def local_leaf(leaf, spec, mesh):
    """The rank's shard of one GLOBAL leaf under `spec`, at its
    coordinates on `mesh` (a `launch.mesh.RankMesh`)."""
    for dim, start, size in _spec_slices(spec, leaf.shape, mesh.sizes,
                                         mesh.coords):
        leaf = leaf.narrow(dim, start, size)
    return leaf.contiguous()


def local_shards(global_params, cfg: ModelConfig, mesh):
    """The rank's local shards of the port's GLOBAL tree (the port's
    layout at global shapes, every leaf whole over `data`): each leaf cut
    along the dims its layout spec (`parallel.sharding.layout_specs`)
    splits, at the rank's coordinates on `mesh` (a
    `launch.mesh.RankMesh`); with cfg.fsdp an fsdp leaf's rows are cut
    to the rank's block of its model shard, as the reference's
    `fsdp_shard_init` cuts them."""
    specs = _specs(cfg, global_params, mesh.sizes.get("model", 1))
    return _zip_specs(lambda leaf, spec: local_leaf(leaf, spec, mesh),
                      global_params, specs)


def global_params(rank_trees, cfg: ModelConfig, mesh_shape, axis_names=(
        "data", "model")):
    """The GLOBAL tree from every rank's local tree (`rank_trees[r]` is
    rank r's, ranks row-major over `mesh_shape`): each region taken from
    the first rank (in rank order) that holds it; with cfg.fsdp the
    fsdp leaves' rows from every data PE (`local_shards`' inverse).
    Parameters, or gradients of the same structure."""
    from ..launch.mesh import RankMesh
    meshes = [RankMesh(tuple(axis_names), tuple(mesh_shape), r)
              for r in range(len(rank_trees))]
    sizes = meshes[0].sizes
    tp = sizes.get("model", 1)
    specs = _specs(cfg, rank_trees[0], tp)

    def walk(trees, spec_tree):
        first = trees[0]
        if isinstance(first, dict):
            return {k: walk([t[k] for t in trees], spec_tree[k])
                    for k in first}
        if isinstance(first, list):
            return [walk([t[i] for t in trees], spec_tree[i])
                    for i in range(len(first))]
        shape = list(first.shape)
        for dim, ax in enumerate(spec_tree):
            if ax is not None:
                axs = ax if isinstance(ax, tuple) else (ax,)
                shape[dim] *= int(np.prod([sizes[a] for a in axs]))
        out = torch.empty(shape, dtype=first.dtype)
        seen = set()
        for leaf, m in zip(trees, meshes):
            region = tuple(_spec_slices(spec_tree, shape, sizes, m.coords))
            if region in seen:
                continue
            seen.add(region)
            view = out
            for dim, start, size in region:
                view = view.narrow(dim, start, size)
            view.copy_(leaf.detach().cpu())
        return out

    return walk(rank_trees, specs)


def _axis_count(ax, sizes: dict) -> int:
    """The PE count of a spec entry: 1 for None, else the product of its
    axes' sizes (a tuple is flattened)."""
    if ax is None:
        return 1
    return int(np.prod([sizes[a] for a in (ax if isinstance(ax, tuple)
                                           else (ax,))]))


def _mamba_columns(cfg: ModelConfig, tp: int, name: str):
    """The column index of a tp = 1 Mamba2 leaf (`w_in`, `conv_w`,
    `conv_b`) that each global column of its `tp`-shard layout reads:
    shard s's columns are [z_s, x_s, B, C, dt_s] of the fused
    in-projection, and [x_s, B, C] of the conv (B and C, one group,
    repeated in every shard); None for the other leaves, whose columns
    are head-blocked and split evenly."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    gdim = s.n_groups * s.state
    nh = d_in // s.head_dim
    di, hl = d_in // tp, nh // tp
    bc = np.arange(2 * gdim)
    cols = []
    for i in range(tp):
        x_s = d_in + np.arange(i * di, (i + 1) * di)
        if name == "w_in":
            cols += [np.arange(i * di, (i + 1) * di), x_s, 2 * d_in + bc,
                     2 * d_in + 2 * gdim + np.arange(i * hl, (i + 1) * hl)]
        elif name in ("conv_w", "conv_b"):
            cols += [x_s - d_in, d_in + bc]
        else:
            return None
    return torch.from_numpy(np.concatenate(cols))


def fit_global(params, cfg: ModelConfig, tp: int, dp: int = 1):
    """The port's tp = 1 tree re-laid-out at the global shapes of a `dp`
    x `tp` mesh, as the reference's `test_tp2_matches_single_device` fits
    its 1x1 params: each leaf tile-extended along every dim that grows
    (ghost heads, padded vocab, padded expert slots, which no token
    routes to) and cut to size; every Mamba2 leaf whose columns are
    per-shard [z_s, x_s, B, C, dt_s] (`w_in`) or [x_s, B, C] (`conv_w`,
    `conv_b`) is rebuilt column by column from the tp = 1 layout (that
    test's `remap_mamba`).  The extended slots are masked to zero effect
    by construction; what still differs from tp = 1 is Mamba2's gated
    norm, which runs over each shard's own channels."""
    from ..launch.mesh import RankMesh
    from .transformer import init_params
    sizes = RankMesh(("data", "model"), (dp, tp), 0).sizes
    local = init_params(cfg, device="meta", tp=tp, dp=dp)   # data-full
    plain = dataclasses.replace(cfg, fsdp=False)
    targets = _zip_specs(
        lambda leaf, spec: tuple(n * _axis_count(ax, sizes)
                                 for n, ax in zip(leaf.shape, spec)),
        local, _specs(plain, local, tp))

    def fit(a, t):
        for ax in range(a.dim()):
            have, want = a.shape[ax], t[ax]
            if have == want:
                continue
            if have < want:
                reps = [1] * a.dim()
                reps[ax] = -(-want // have)
                a = a.repeat(*reps)
            a = a.narrow(ax, 0, want)
        return a.contiguous()

    def walk(tree, tgt, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, tgt[k], path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, t, path) for v, t in zip(tree, tgt)]
        cols = _mamba_columns(cfg, tp, path[-1]) \
            if tp > 1 and "mamba" in path else None
        if cols is None:
            return fit(tree, tgt)
        return tree.index_select(-1, cols.to(tree.device)).contiguous()

    return walk(params, targets)


def shards_from_jax(tree, cfg: ModelConfig, mesh, device="cpu"):
    """The rank's local shards of the port from the reference's GLOBAL
    tree (numpy, the layout `repro.launch.build.global_shape` gives:
    layers stacked) on `mesh` (a `launch.mesh.RankMesh`)."""
    return local_shards(params_from_jax(tree, cfg, device), cfg, mesh)
