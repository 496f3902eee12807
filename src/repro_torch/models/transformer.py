"""Model assembly: parameters, the full-sequence entries (`forward`,
`train_loss`, `prefill`) of every family, the dense-cache
`init_cache`/`decode_step` of every family but the audio encoder, and
the KV pools and paged prefill/decode entries of the dense and vlm
families.

Counterpart of `repro/models/transformer.py`.  Parameters hold one
dict per layer in `params["layers"]` (the JAX package stacks each leaf
to [n_layers, ...] for `lax.scan`); the stack is a Python loop.  Decode
caches likewise hold one dict per layer.  gemma2's local/global pairs (`local_global_period`)
are layers 2i (local: the sliding `local_window`) and 2i + 1 (global) of
that one list, where the reference scans stacked `pairs` ("local",
"global"); gemma2 also scales its embedding by sqrt(d).  The hybrid
family (zamba2) applies one shared attention + MLP block,
`params["shared_attn"]`, after every segment of `hybrid_attn_period`
Mamba2 layers, the last, shorter one included; each application has its
own KV cache in `cache["shared"]`.  The moe family (granite-moe,
deepseek-v3) runs its first `moe.first_dense_layers` blocks (attention +
MLP) from `params["dense_layers"]`, then attention + MoE blocks from
`params["layers"]`, each attention GQA or MLA (`cfg.attn`); with
`cfg.mtp`, `params["mtp"]` holds the depth-1 multi-token-prediction head
`train_loss` adds.  Its decode caches follow the same two lists.  The
audio (hubert, an encoder: `causal=False`) and vlm (phi-3-vision) families
run the dense family's attention + MLP layers: audio from stub frame
embeddings (B, L, d) in place of the token embedding, vlm with stub image
embeddings over the first `frontend_embeds.shape[1]` positions of the
embedded tokens.  An encoder has no decode step.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.utils.checkpoint

from .. import resolve_device
from ..core.trace import region
from ..kernels import paged_decode as kpd
from ..parallel.comm import Comm
from . import layers as L
from .config import ModelConfig

Params = dict


FAMILIES = ("dense", "ssm", "hybrid", "moe", "audio", "vlm")
# the families whose layers are attention + MLP blocks, one list of them
_ATTN_FAMILIES = ("dense", "vlm", "audio")
# the families with a decode step: all but the audio encoder
_DECODE_FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm")


def paged_families() -> tuple[str, ...]:
    """Families the paged serving path supports (attention KV caches;
    SSM and MLA state is not paged)."""
    return ("dense", "vlm")


def _check_family(cfg: ModelConfig, families=FAMILIES):
    """Raise ValueError unless `cfg`'s family is among `families` (the
    reference raises ValueError(family) where a branch is missing)."""
    if cfg.family not in families:
        raise ValueError(f"{cfg.name!r} ({cfg.family}): this entry takes "
                         f"the {', '.join(families)} families")


def _is_local(cfg: ModelConfig, i: int) -> bool:
    """Whether layer i is a local (sliding-window) layer: the first of
    each of gemma2's local/global pairs."""
    return cfg.local_global_period is not None and i % 2 == 0


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None, tp: int = 1,
                dp: int = 1) -> Params:
    """Random parameters from a `torch.Generator` seeded with `seed`, made
    on `device` (default: the CUDA card; raises without one unless
    ``device="cpu"``): one rank's local shards on a mesh of `tp` model
    PEs and `dp` data PEs (the reference's ``init_params(key, cfg, tp,
    dp)``).  Every rank draws from the same seed, so replicated leaves
    are identical everywhere and sharded leaves are consistent
    shard-local draws, as the reference's shard_map init gives them.
    On the meta device it gives the shapes and dtypes alone.  Each weight of two or more dims is drawn in f32
    and cast to `cfg.param_dtype` as soon as it is made (as `repro` casts
    its f32 tree), so no f32 copy of the whole tree exists; vectors stay
    f32, but those of a layer the reference stacks ("layers",
    "dense_layers"), which have two dims in its stacked tree and so take
    its cast (`_stacked_layer`).  gemma2's layers are made in the list's
    order, pair by pair; the moe family's dense layers, then its MoE
    layers, then the MTP head.
    deepseek-v3's expert leaves are drawn whole: (256, 7168, 2048) in f32
    is 15 GiB for an instant, beside the bf16 leaves made before it."""
    _check_family(cfg)
    if cfg.local_global_period is not None and cfg.n_layers % 2:
        raise ValueError(f"local/global pairs need an even n_layers, not "
                         f"{cfg.n_layers}")
    device = resolve_device(device)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    p: Params = {"embed": L.init_embedding(gen, cfg, tp, device),
                 "final_norm": torch.zeros(cfg.d_model, device=device)}
    if cfg.family in _ATTN_FAMILIES:
        p["layers"] = [_init_attn_block(gen, cfg, tp, device)
                       for _ in range(cfg.n_layers)]
    elif cfg.family == "moe":
        nd = cfg.moe.first_dense_layers
        if nd:
            p["dense_layers"] = [_init_attn_block(gen, cfg, tp, device)
                                 for _ in range(nd)]
        p["layers"] = [_init_attn_block(gen, cfg, tp, device, moe=True,
                                        dp=dp)
                       for _ in range(cfg.n_layers - nd)]
        if cfg.mtp:
            d = cfg.d_model
            p["mtp"] = {"proj": L._normal(gen, (2 * d, d),
                                          1.0 / math.sqrt(2 * d), device,
                                          cfg.param_dtype),
                        "block": _init_attn_block(gen, cfg, tp, device),
                        "ln": torch.zeros(d, device=device)}
    else:
        p["layers"] = [
            {"mamba": L.init_mamba2(gen, cfg, tp, device),
             "ln": torch.zeros(cfg.d_model, device=device)}
            for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        p["shared_attn"] = _init_attn_block(gen, cfg, tp, device)
    for key in ("layers", "dense_layers"):
        if key in p:
            p[key] = [_stacked_layer(cfg, layer) for layer in p[key]]
    return p


def _stacked_layer(cfg: ModelConfig, layer: Params) -> Params:
    """A layer of a list the reference stacks, its vectors cast to
    `cfg.param_dtype`: the reference casts each leaf of two or more dims
    of its tree, and a stacked vector has two (a mirrored quirk: a
    bf16 config keeps its layer norms in bf16)."""
    if cfg.param_dtype == torch.float32:
        return layer
    return map_params(lambda t: t.to(cfg.param_dtype) if t.dim() == 1
                      else t, layer)


def _init_attn_block(gen, cfg, tp, device, moe: bool = False,
                     dp: int = 1) -> Params:
    """An attention (GQA, or MLA when ``cfg.attn == "mla"``) block with
    an MLP, or with an MoE layer under "moe"."""
    attn = (L.init_mla(gen, cfg, tp, device) if cfg.attn == "mla"
            else L.init_attention(gen, cfg, tp, device))
    ffn = ({"moe": L.init_moe(gen, cfg, tp, device, dp)} if moe
           else {"mlp": L.init_mlp(gen, cfg, tp, device)})
    return {"attn": attn, **ffn,
            "ln1": torch.zeros(cfg.d_model, device=device),
            "ln2": torch.zeros(cfg.d_model, device=device)}


def _shared_after(cfg: ModelConfig, i: int) -> bool:
    """Whether the hybrid family's shared block follows layer i: at the
    end of each segment of `hybrid_attn_period` layers and after the
    last layer."""
    return cfg.family == "hybrid" and (
        (i + 1) % cfg.hybrid_attn_period == 0 or i == cfg.n_layers - 1)


def n_shared_blocks(cfg: ModelConfig) -> int:
    """Applications of the hybrid family's shared block in one pass:
    ceil(n_layers / hybrid_attn_period)."""
    return -(-cfg.n_layers // cfg.hybrid_attn_period)


def map_params(fn, tree):
    """Apply `fn` to every tensor of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_params(fn, v) for v in tree]
    return fn(tree)


def init_kv_pool(cfg: ModelConfig, tp: int, num_pages: int, page_size: int,
                 device) -> Params:
    """Paged KV pools of every layer: {"k", "v"} of shape (n_layers,
    num_pages, page_size, K, hd), K this rank's kv heads at `tp`
    (`layers.init_attn_cache`).  Page p of a sequence lives at the same
    physical index in every layer's pool, so one page table serves the
    whole stack."""
    _check_family(cfg, paged_families())
    flat = L.init_attn_cache(cfg, tp, cfg.n_layers * num_pages, page_size,
                             device)
    return {name: t.view((cfg.n_layers, num_pages) + tuple(t.shape[1:]))
            for name, t in flat.items()}


def _fsdp_gather(comm: Comm, cfg: ModelConfig, bp):
    """ZeRO-3: a block's weights live sharded over `data` (dim 0 of every
    2-D leaf, `parallel.sharding.is_fsdp_leaf`); gather them just in
    time inside the block, so a gathered layer is transient (and under
    remat gathered again in the backward).  The gather's backward sends
    each block's cotangent back to the PE that owns it, where they sum:
    fsdp leaves arrive in the gradient tree already summed over `data`
    (the train step does not sync them)."""
    if not cfg.fsdp:
        return bp
    return map_params(lambda w: comm.allgather(w, comm.axes.data,
                                               concat_axis=0)
                      if w.dim() == 2 else w, bp)


def _attn_block(comm, cfg, bp, x, positions, is_local=False):
    """-> (x, aux): aux is an MoE block's load-balance loss, None after
    an MLP."""
    bp = _fsdp_gather(comm, cfg, bp)
    h = L.rms_norm(x, bp["ln1"])
    if cfg.attn == "mla":
        x = x + L.mla_attention(comm, cfg, bp["attn"], h, positions)
    else:
        x = x + L.attention(comm, cfg, bp["attn"], h, positions,
                            is_local_layer=is_local)
    h = L.rms_norm(x, bp["ln2"])
    if "moe" in bp:
        m, aux = L.moe(comm, cfg, bp["moe"], h)
        return x + m, aux
    return x + L.mlp(comm, cfg, bp["mlp"], h), None


def _mamba_block(comm, cfg, bp, x):
    bp = _fsdp_gather(comm, cfg, bp)
    return x + L.mamba2(comm, cfg, bp["mamba"], L.rms_norm(x, bp["ln"]))


# what remat="selective" keeps from the forward: the outputs of the
# plain weight products, which have no batch dims (the reference's
# `dots_with_no_batch_dims_saveable`); attention's batched products and
# the elementwise chains are recomputed
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _selective_policy(ctx, op, *args, **kwargs):
    return (torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
            if op in _SAVED_OPS
            else torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(cfg: ModelConfig, fn):
    """`fn` recomputed in the backward pass when ``cfg.remat == "full"``
    (the reference's `jax.checkpoint`); under "selective" with the
    outputs of its 2-D weight products saved and the rest recomputed
    (`_selective_policy`); else `fn`."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda *a: torch.utils.checkpoint.checkpoint(
            fn, *a, use_reentrant=False)
    if cfg.remat != "selective":
        raise ValueError(f"remat={cfg.remat!r}: none|full|selective")
    ctx = functools.partial(
        torch.utils.checkpoint.create_selective_checkpoint_contexts,
        _selective_policy)
    return lambda *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False, context_fn=ctx)


def _embed_scaled(comm, cfg, params, tokens):
    """The token embedding; gemma2 (a local/global config) scales it by
    sqrt(d) rounded to cfg.dtype first, as `repro` multiplies by
    ``jnp.asarray(sqrt(d), cfg.dtype)``."""
    x = L.embed(comm, cfg, params["embed"], tokens)
    if cfg.local_global_period:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype,
                             device=x.device)
    return x


def forward(comm: Comm, cfg: ModelConfig, params: Params, tokens=None, *,
            frames=None, frontend_embeds=None):
    """Full-sequence forward: tokens (B, L) -> (hidden (B, L, d), aux
    loss), aux the sum of the MoE layers' load-balance losses (0 without
    MoE layers).  The audio frontend starts from `frames` (B, L, d) in
    place of tokens; the vision frontend's `frontend_embeds` (B, nf, d),
    when given, replace the first nf positions of the embedded tokens."""
    _check_family(cfg)
    if cfg.frontend == "audio":
        x = frames.to(cfg.dtype)
        B, seq = x.shape[0], x.shape[1]
    else:
        x = _embed_scaled(comm, cfg, params, tokens)
        B, seq = tokens.shape
    if cfg.frontend == "vision" and frontend_embeds is not None:
        nf = frontend_embeds.shape[1]
        x = torch.cat([frontend_embeds.to(cfg.dtype), x[:, nf:]], 1)
    positions = torch.arange(seq, device=x.device).expand(B, seq)
    aux_total = torch.zeros((), device=x.device)
    if cfg.family == "moe":
        for bp in params.get("dense_layers", []):
            x, _ = _maybe_remat(cfg, lambda x, bp=bp: _attn_block(
                comm, cfg, bp, x, positions))(x)
        for bp in params["layers"]:
            x, aux = _maybe_remat(cfg, lambda x, bp=bp: _attn_block(
                comm, cfg, bp, x, positions))(x)
            aux_total = aux_total + aux
    else:
        for i, bp in enumerate(params["layers"]):
            if cfg.family in _ATTN_FAMILIES:
                x, _ = _maybe_remat(
                    cfg, lambda x, bp=bp, i=i: _attn_block(
                        comm, cfg, bp, x, positions, _is_local(cfg, i)))(x)
            else:
                x = _maybe_remat(
                    cfg, lambda x, bp=bp: _mamba_block(comm, cfg, bp, x))(x)
            if _shared_after(cfg, i):
                x, _ = _maybe_remat(cfg, lambda x: _attn_block(
                    comm, cfg, params["shared_attn"], x, positions))(x)
    x = L.rms_norm(x, params["final_norm"])
    return x, aux_total


def prefill(comm: Comm, cfg: ModelConfig, params: Params, tokens=None, *,
            frames=None, frontend_embeds=None):
    """Prefill forward: tokens (B, L) (or the audio frontend's frames,
    with the vision frontend's embeds; see `forward`) -> last-position
    logits (B, 1, vocab_local).  As in the reference, the forward pass is
    the prefill; it fills no decode cache."""
    h, _ = forward(comm, cfg, params, tokens, frames=frames,
                   frontend_embeds=frontend_embeds)
    return L.lm_logits(comm, cfg, params["embed"], h[:, -1:])


def init_cache(cfg: ModelConfig, tp: int, batch_local: int, cache_len: int,
               seq_shards: int = 1, *, device=None) -> Params:
    """Dense decode caches, one dict per layer under "layers", on `device`
    (default: the CUDA card, as `init_params`).  dense and vlm: an
    attention cache {"k", "v"} (B, S, K, hd) in cfg.dtype, S =
    min(cache_len, the layer's window): a local layer of gemma2 holds a
    ring of min(cache_len, local_window) slots; ssm: a Mamba2 cache
    {"conv": (B, conv_width - 1, conv_dim) in cfg.dtype, "ssm": (B, H, P,
    N) f32}, which has no length; hybrid: Mamba2 caches under "layers" and one
    attention cache per application of the shared block under "shared";
    moe: an attention cache (GQA, or MLA's latent {"c_kv", "k_rope"}) per
    layer under "dense_layers" and "layers", as its parameters.
    The dense and vlm families' serving engine decodes through the paged
    KV pool (`init_kv_pool`) instead.  At `tp` > 1 the caches are one
    rank's: its kv heads (under the replicated-KV plan the distinct
    heads its q heads read, `layers.kv_cache_plan`) and its SSM heads and
    conv channels; MLA's latent cache is replicated.  With `seq_shards`
    > 1 (the sequence-sharded decode, `layers.attention_decode`) each
    attention cache holds S = cache_len // seq_shards slots, a windowed
    one min(S, window), and so does MLA's latent cache (whose decode
    ignores the sharding, as the reference's `mla_decode` does); the
    Mamba2 caches have no length.  The audio encoder has no decode cache
    and raises ValueError, as the reference's."""
    _check_family(cfg, _DECODE_FAMILIES)
    device = resolve_device(device)
    S = cache_len // seq_shards

    def attn(is_local=False):
        return L.init_attn_cache(cfg, tp, batch_local, S, device,
                                 window_bound=L.layer_window(cfg, is_local))

    if cfg.family in ("dense", "vlm"):
        return {"layers": [attn(_is_local(cfg, i))
                           for i in range(cfg.n_layers)]}
    if cfg.family == "moe":
        def one():
            if cfg.attn == "mla":
                return L.init_mla_cache(cfg, batch_local, S, device)
            return attn()
        nd = cfg.moe.first_dense_layers
        out = {"layers": [one() for _ in range(cfg.n_layers - nd)]}
        if nd:
            out["dense_layers"] = [one() for _ in range(nd)]
        return out
    cache = {"layers": [L.init_mamba_cache(cfg, tp, batch_local, device)
                        for _ in range(cfg.n_layers)]}
    if cfg.family == "hybrid":
        cache["shared"] = [attn() for _ in range(n_shared_blocks(cfg))]
    return cache


def _attn_decode_block(comm, cfg, bp, x, cache, positions, is_local=False,
                       seq_shards=1):
    h = L.rms_norm(x, bp["ln1"])
    if cfg.attn == "mla":
        a, cache = L.mla_decode(comm, cfg, bp["attn"], h, cache, positions)
    else:
        a, cache = L.attention_decode(comm, cfg, bp["attn"], h, cache,
                                      positions, is_local_layer=is_local,
                                      seq_shards=seq_shards)
    x = x + a
    h = L.rms_norm(x, bp["ln2"])
    if "moe" in bp:
        return x + L.moe(comm, cfg, bp["moe"], h)[0], cache
    return x + L.mlp(comm, cfg, bp["mlp"], h), cache


def decode_step(comm: Comm, cfg: ModelConfig, params: Params, cache: Params,
                tokens, positions, *, seq_shards: int = 1):
    """One decode step against `init_cache`'s caches: tokens (B, 1),
    positions (B,) -> (logits (B, 1, vocab_local), new cache).  Attention
    caches are written in place and handed back; Mamba2 caches come back
    as new tensors (a Mamba2 layer reads no position).  `seq_shards` > 1:
    the attention caches are sequence shards over `data`
    (`init_cache(seq_shards)`, `layers.attention_decode`)."""
    _check_family(cfg, _DECODE_FAMILIES)
    x = _embed_scaled(comm, cfg, params, tokens)
    blk = functools.partial(_attn_decode_block, seq_shards=seq_shards)
    if cfg.family == "moe":
        new = {}
        for group in ("dense_layers", "layers"):
            for bp, c in zip(params.get(group, []), cache.get(group, [])):
                x, c = blk(comm, cfg, bp, x, c, positions)
                new.setdefault(group, []).append(c)
    else:
        new = {"layers": []}
        for i, (bp, c) in enumerate(zip(params["layers"], cache["layers"])):
            if cfg.family in ("dense", "vlm"):
                x, c = blk(comm, cfg, bp, x, c, positions, _is_local(cfg, i))
            else:
                y, c = L.mamba2_decode(comm, cfg, bp["mamba"],
                                       L.rms_norm(x, bp["ln"]), c)
                x = x + y
            new["layers"].append(c)
            if _shared_after(cfg, i):
                shared = new.setdefault("shared", [])
                x, c = blk(comm, cfg, params["shared_attn"], x,
                           cache["shared"][len(shared)], positions)
                shared.append(c)
    x = L.rms_norm(x, params["final_norm"])
    return L.lm_logits(comm, cfg, params["embed"], x), new


def train_loss(comm: Comm, cfg: ModelConfig, params: Params, batch: dict):
    """Token-mean cross-entropy of batch {"tokens", "targets"} (B, L)
    (audio: {"frames", "targets"}; vision: with "frontend_embeds"); with
    `cfg.mtp`, plus 0.1 x the depth-1 MTP head's loss (h_t combined
    with the embedding of target t predicts target t + 1); with MoE
    layers, plus 0.01 x aux / n_layers."""
    h, aux = forward(comm, cfg, params, batch.get("tokens"),
                     frames=batch.get("frames"),
                     frontend_embeds=batch.get("frontend_embeds"))
    logits = L.lm_logits(comm, cfg, params["embed"], h)
    targets = batch["targets"]
    loss = L.sharded_xent(comm, cfg, logits, targets).mean()
    if cfg.mtp and "mtp" in params:
        mtp = params["mtp"]
        emb_next = L.embed(comm, cfg, params["embed"], targets)
        proj = _fsdp_gather(comm, cfg, {"w": mtp["proj"]})["w"]
        hm = L._dense(torch.cat([L.rms_norm(h, mtp["ln"]), emb_next], -1),
                      proj)
        B, seq = targets.shape
        positions = torch.arange(seq, device=h.device).expand(B, seq)
        hm, _ = _attn_block(comm, cfg, mtp["block"], hm, positions)
        lg2 = L.lm_logits(comm, cfg, params["embed"], hm[:, :-1])
        mtp_loss = L.sharded_xent(comm, cfg, lg2, targets[:, 1:]).mean()
        loss = loss + 0.1 * mtp_loss
    if cfg.moe is not None:
        loss = loss + 0.01 * aux / max(cfg.n_layers, 1)
    return loss


def _attn_block_paged(comm, cfg, bp, x, pool, page_table, positions,
                      page_size, positions_checked, is_local=False,
                      decode_rows=None):
    h = L.rms_norm(x, bp["ln1"])
    a, _ = L.attention_paged(comm, cfg, bp["attn"], h, pool, page_table,
                             positions, page_size=page_size,
                             is_local_layer=is_local,
                             positions_checked=positions_checked,
                             decode_rows=decode_rows)
    with region(comm.profile, "layer.mlp"):
        x = x + a
        h = L.rms_norm(x, bp["ln2"])
        return x + L.mlp(comm, cfg, bp["mlp"], h)


def _paged_stack(comm, cfg, params, pool, page_table, x, positions,
                 page_size, positions_checked=False, decode_rows=None):
    """Run the layer stack against the paged KV pools, updating them in
    place.  One code path for prefill (L = prompt bucket) and decode
    (L = 1, every layer sharing the step's `decode_rows`).  A local
    layer's window is a mask only: every layer's pool keeps the whole
    sequence, as in the reference."""
    for i, bp in enumerate(params["layers"]):
        layer_pool = {"k": pool["k"][i], "v": pool["v"][i]}
        x = _attn_block_paged(comm, cfg, bp, x, layer_pool, page_table,
                              positions, page_size, positions_checked,
                              _is_local(cfg, i), decode_rows)
    return x, pool


def _paged_model(comm, cfg, params, pool, page_table, tokens, positions,
                 page_size, prefill):
    """Embedding (a prefill's positions checked first, a decode's page
    table and positions made once into the `decode_rows` every layer's
    attention shares), the paged layer stack and the LM head, each a
    range of the tracer on `comm` (`core.trace.region`): ``model.embed``,
    ``model.layers`` (each layer's first norm outside its own ranges)
    and ``model.head`` (the final norm and the logits)."""
    prof = comm.profile
    rows = None
    with region(prof, "model.embed"):
        if prefill:
            L.check_prefill_positions(positions)
        else:
            rows = kpd.decode_rows(page_table, positions[:, 0],
                                   page_size=page_size)
        x = _embed_scaled(comm, cfg, params, tokens)
    with region(prof, "model.layers"):
        x, pool = _paged_stack(comm, cfg, params, pool, page_table, x,
                               positions, page_size,
                               positions_checked=prefill, decode_rows=rows)
    with region(prof, "model.head"):
        x = L.rms_norm(x, params["final_norm"])
        return L.lm_logits(comm, cfg, params["embed"], x), pool


def prefill_paged(comm: Comm, cfg: ModelConfig, params: Params, pool: Params,
                  page_table, tokens, positions, *, page_size: int):
    """One forward pass over the whole prompt bucket that also fills the
    sequence's KV pages.  tokens, positions: (B, L_bucket).  Returns
    (full-bucket logits (B, L, vocab_local), pool).  Rows past the true
    prompt length write garbage K/V into the row's own reserved (or null)
    pages; decode overwrites each position before the causal mask can
    expose it.  positions must be arange(L) in every row; that is checked
    once here, not in every layer."""
    return _paged_model(comm, cfg, params, pool, page_table, tokens,
                        positions, page_size, prefill=True)


def decode_step_paged(comm: Comm, cfg: ModelConfig, params: Params,
                      pool: Params, page_table, tokens, positions, *,
                      page_size: int):
    """One paged decode step: tokens (B,1), positions (B,) -> (logits
    (B,1,vocab_local), pool)."""
    return _paged_model(comm, cfg, params, pool, page_table, tokens,
                        positions[:, None], page_size, prefill=False)
