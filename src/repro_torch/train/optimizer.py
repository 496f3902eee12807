"""AdamW in plain torch, with optimizer-state compression (port of
`repro/train/optimizer.py`).

  * moment dtype f32 / bf16 / int8: int8 moments use 128-element
    blockwise absmax scales (the symmetric heap's alignment unit), second
    moments in the sqrt domain.
  * The update's operations run in the reference's order, each one
    correctly rounded f32 operation (the sqrt through `ref.sqrt_rn`), so
    the fused kernel (`kernels/fused_update.py`) equals this bit for bit.
  * Weight decay applies to a leaf whose rank in the reference's STACKED
    layout is at least 2 (`decay_flags`): the port keeps one dict per
    layer, where a norm or a bias is 1-D, but the reference stacks every
    per-layer leaf to [n_layers, ...] and decays all of them.  Every list
    of per-layer dicts at the top of the tree is such a stack ("layers",
    and the moe family's "dense_layers").
  * int8 moments are blocked in that stacked layout too (`moment_groups`):
    a per-layer leaf is quantised over the concatenation of its layers,
    so a 128-element block may span two layers, as the reference's block
    of the stacked leaf does.  A local/global config (gemma2,
    `local_global_period`) keeps its layers as two stacks in the
    reference, `pairs/local` and `pairs/global`: the port's even
    "layers" (local) are blocked apart from its odd ones (global).

The state is {"mv": one {"m", "v"} per moment group (`moment_groups`:
one per leaf in `heap.tree_flatten` order for f32 and bf16 moments),
"step": int32 0-d tensor}, on the parameters' device.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..core.heap import tree_flatten, tree_unflatten
from ..kernels.ref import sqrt_rn

BLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "f32"      # f32 | bf16 | int8


def _q_encode(x32, dtype: str, nonneg: bool = False):
    if dtype == "f32":
        return x32
    if dtype == "bf16":
        return x32.to(torch.bfloat16)
    if dtype != "int8":
        raise ValueError(f"moment_dtype {dtype!r} not in f32|bf16|int8")
    # int8 blockwise absmax; non-negative tensors (second moments) are
    # stored in the sqrt domain, which linearises their dynamic range
    flat = x32.reshape(-1)
    fp = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    if nonneg:
        fp = sqrt_rn(fp.clamp_min(0.0))
    scale = fp.abs().amax(1, keepdim=True) / torch.full(
        (), 127.0, device=fp.device)
    q = torch.round(fp / scale.clamp_min(1e-20)).to(torch.int8)
    return {"q": q, "scale": scale}


def _q_decode(s, dtype: str, shape=None, nonneg: bool = False):
    if dtype == "f32":
        return s
    if dtype == "bf16":
        return s.float()
    flat = s["q"].float() * s["scale"]
    if nonneg:
        flat = flat * flat
    return flat.reshape(-1)[:math.prod(shape)].reshape(shape)


def _stacked(params, key) -> bool:
    """Whether `params[key]` is a list of per-layer dicts, which the
    reference stacks to one leaf per name."""
    return isinstance(params[key], list) and bool(params[key])


def decay_flags(params) -> list[bool]:
    """Per leaf, in `tree_flatten` order: whether AdamW decays it, i.e.
    whether its rank is at least 2 in the reference's stacked layout
    (every leaf of a `_stacked` list has one more dim there)."""
    if not isinstance(params, dict):
        return [l.dim() >= 2 for l in tree_flatten(params)[0]]
    flags = []
    for key in sorted(params):
        extra = 1 if _stacked(params, key) else 0
        flags += [l.dim() + extra >= 2 for l in tree_flatten(params[key])[0]]
    return flags


def _stacks(key: str, n_layers: int, local_global_period) -> list:
    """The layers of a `_stacked` list that the reference stacks together:
    all of them, or for a local/global config's "layers" the even (local,
    `pairs/local`) and the odd ones (global, `pairs/global`) apart, as
    `models/convert.py` maps them."""
    if key == "layers" and local_global_period is not None:
        return [range(0, n_layers, 2), range(1, n_layers, 2)]
    return [range(n_layers)]


def moment_groups(params, moment_dtype: str,
                  local_global_period: int | None = None) -> list[list[int]]:
    """The leaves (indices in `tree_flatten` order) that share one moment
    encoding.  f32 and bf16 moments are elementwise: one group per leaf.
    int8 blocks follow the reference's stacked layout: each leaf of a
    `_stacked` list (``params["layers"]``, ``params["dense_layers"]``) is
    grouped with the same leaf of every other layer of its stack (in
    layer order; `_stacks`: a config with `local_global_period` has two
    in "layers"), each other leaf stands alone."""
    n = len(tree_flatten(params)[0])
    if moment_dtype != "int8" or not isinstance(params, dict):
        return [[i] for i in range(n)]
    groups, start = [], 0
    for key in sorted(params):
        sub = tree_flatten(params[key])[0]
        if _stacked(params, key):
            per = len(tree_flatten(params[key][0])[0])
            for stack in _stacks(key, len(params[key]), local_global_period):
                groups += [[start + layer * per + j for layer in stack]
                           for j in range(per)]
        else:
            groups += [[start + j] for j in range(len(sub))]
        start += len(sub)
    return sorted(groups)


def bias_corrections(cfg: AdamWConfig, step):
    """(c1, c2) = (1 - b1**t, 1 - b2**t) for the int32 step tensor `step`,
    as f32 0-d tensors on its device (no host read)."""
    t = step.float()
    return 1.0 - torch.pow(cfg.b1, t), 1.0 - torch.pow(cfg.b2, t)


def init_state(params, cfg: AdamWConfig,
               local_global_period: int | None = None):
    """Zero moments in `moment_groups`' groups (`local_global_period`:
    the model config's, which splits a local/global tree's int8 blocks)
    and step 0."""
    leaves, _ = tree_flatten(params)

    def one(group):
        shape = leaves[group[0]].shape if len(group) == 1 else \
            (sum(leaves[i].numel() for i in group),)
        dev = leaves[group[0]].device
        # m and v each in storage of its own: an in-place step writes both
        return {"m": _q_encode(torch.zeros(shape, device=dev),
                               cfg.moment_dtype),
                "v": _q_encode(torch.zeros(shape, device=dev),
                               cfg.moment_dtype, nonneg=True)}

    return {"mv": [one(g) for g in moment_groups(params, cfg.moment_dtype,
                                                 local_global_period)],
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def apply_updates(params, grads, state, cfg: AdamWConfig,
                  local_global_period: int | None = None, *,
                  inplace: bool = False):
    """One AdamW step: (new params, new state), the reference's
    arithmetic operation for operation.  `local_global_period` must be
    the one `init_state` was given.  With `inplace` and f32 moments the
    parameters and moments are updated in their own storage by the same
    operations in the same order (bit for bit the same result, and no
    second copy of the state): the caller gives up the trees it passed.
    Other moment dtypes are re-encoded out of place either way."""
    step = state["step"] + 1
    c1, c2 = bias_corrections(cfg, step)
    inplace = inplace and cfg.moment_dtype == "f32"

    def one(p, g, m, v, decay):
        g32 = g.float()
        if inplace:
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        else:
            m = cfg.b1 * m + (1 - cfg.b1) * g32
            v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        upd = (m / c1) / (sqrt_rn(v / c2) + cfg.eps)
        if decay:
            upd = upd + cfg.weight_decay * p.float()
        if inplace:
            if p.dtype == torch.float32:
                return p.sub_(cfg.lr * upd), m, v
            return p.copy_(p.float() - cfg.lr * upd), m, v
        return (p.float() - cfg.lr * upd).to(p.dtype), m, v

    flat_p, treedef = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    decays = decay_flags(params)
    groups = moment_groups(params, cfg.moment_dtype, local_global_period)
    if len(groups) != len(state["mv"]):
        raise ValueError(f"the state holds {len(state['mv'])} moment groups"
                         f", the parameters make {len(groups)}: init_state "
                         f"was given another tree or local_global_period")
    new_p, new_mv = [None] * len(flat_p), []
    for group, mv in zip(groups, state["mv"]):
        # the group's moments as one flat f32 run (its layers in order),
        # then each leaf's slice of it
        size = sum(flat_p[i].numel() for i in group)
        shape = flat_p[group[0]].shape if len(group) == 1 else (size,)
        m = _q_decode(mv["m"], cfg.moment_dtype, shape).reshape(-1)
        v = _q_decode(mv["v"], cfg.moment_dtype, shape,
                      nonneg=True).reshape(-1)
        ms, vs, off = [], [], 0
        for i in group:
            k = flat_p[i].numel()
            shp = flat_p[i].shape
            new_p[i], mi, vi = one(flat_p[i], flat_g[i],
                                   m[off:off + k].reshape(shp),
                                   v[off:off + k].reshape(shp), decays[i])
            ms.append(mi.reshape(-1))
            vs.append(vi.reshape(-1))
            off += k
        m = ms[0] if len(group) == 1 else torch.cat(ms)
        v = vs[0] if len(group) == 1 else torch.cat(vs)
        new_mv.append({"m": _q_encode(m.reshape(shape), cfg.moment_dtype),
                       "v": _q_encode(v.reshape(shape), cfg.moment_dtype,
                                      nonneg=True)})
    return (tree_unflatten(treedef, new_p),
            {"mv": new_mv, "step": step})
