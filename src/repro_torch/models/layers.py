"""Model layers of the dense family (the full-sequence training path, the
paged serving path and the dense-cache decode) and of the ssm family
(Mamba2: the full-sequence prefill through the SSD scan and the one-step
decode recurrence); the hybrid family is built of both; the moe family
adds MLA (deepseek-v3's latent attention: the full-sequence form through
the flash kernel, the absorbed decode in f32) and the routed MoE layer.

Counterpart of `repro/models/layers.py`.  Each function takes a `Comm`
and calls its collectives where `repro` does; on one device they are the
identity.  Megatron-style tensor parallelism over `model` (the dense
family's training path): attention heads and the FFN hidden are sharded,
every layer ends with one allreduce, the vocabulary is sharded for the
embedding and the loss; KV projections are replicated when n_kv_heads <
tp or tp does not divide the heads, whose padded "ghost" q heads are
masked to zero.  MLA splits its q heads over `model` (the latent
projections replicated), Mamba2 its SSM heads (each shard's columns of
the fused in-projection are [z, x, B, C, dt] of its own heads, B and C
replicated), and the MoE layer shards its experts over the EP group
(`model`, or (data, model) under `ep_over_data`) with the paper's
pairwise alltoall.  Every decode path runs at tp > 1 on the rank's
shards; a replicated-KV cache stores only the distinct KV heads each
device's q heads read (`kv_cache_plan`).  Over a data axis of more than
one PE, `attention` runs the sequence-sharded ring (`attention="ring"`,
on the shmem backend) and `attention_decode` a cache whose sequence is
sharded over `data` (`seq_shards`), its softmax statistics combined by
allreduces there.
Weights are
plain tensors in dicts, initialised from a `torch.Generator`.  The paged
KV pool and the dense KV cache are updated in place (the JAX functions
return new ones), MLA's latent cache too: no copy per step.
Gradients come from autograd; attention's goes through the
`kernels/ops.attention` Function, the SSD scan's through `ops.ssd`.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.trace import region
from ..kernels import ops as kops
from ..kernels import paged_decode as kpd
from ..kernels import ref as kref
from ..kernels.ref import NEG_INF, paged_kv_gather
from ..parallel.comm import Comm
from .config import ModelConfig

Params = dict


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def rope(x, positions, theta: float):
    """x: (..., L, H, D) with D even; positions: (..., L).  Half-split
    rotation."""
    d = x.shape[-1]
    half = d // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=x.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions[..., None].float() * freqs          # (..., L, half)
    cos = torch.cos(ang)[..., None, :]                  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def _dense(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _normal(gen, shape, scale: float, device, dtype):
    """A weight drawn in f32 from `gen`, then cast to `dtype` at once, so
    that a bf16 tree never holds more than one f32 leaf at a time and
    draws the same numbers as an f32 one.  The draw is scaled in place:
    deepseek-v3's (256, 7168, 2048) expert leaves are 15 GiB each in
    f32.  On the meta device (shapes only) nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device=device, dtype=dtype)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# embedding / LM head
# ---------------------------------------------------------------------------

def init_embedding(gen, cfg: ModelConfig, tp: int, device) -> Params:
    v_local = -(-cfg.vocab // tp)
    scale = 1.0 / math.sqrt(cfg.d_model)
    dt = cfg.param_dtype
    p = {"table": _normal(gen, (v_local, cfg.d_model), scale, device, dt)}
    if not cfg.tie_embeddings:
        p["head"] = _normal(gen, (cfg.d_model, v_local), scale, device, dt)
    return p


def embed(comm: Comm, cfg: ModelConfig, p: Params, tokens):
    """tokens: (B, L) global ids -> (B, L, d).  Ids outside this shard's
    vocabulary embed to zero (as in `repro`), rather than raising."""
    v_local = p["table"].shape[0]
    base = comm.axis_index(comm.axes.model) * v_local
    local_ids = tokens - base
    ok = (local_ids >= 0) & (local_ids < v_local)
    emb = p["table"][local_ids.clamp(0, v_local - 1)]
    emb = torch.where(ok[..., None], emb, 0.0)
    emb = comm.allreduce(emb, comm.axes.model)
    return emb.to(cfg.dtype)


def lm_logits(comm: Comm, cfg: ModelConfig, p: Params, x):
    w = p["table"].T if cfg.tie_embeddings else p["head"]
    return _dense(x, w.to(cfg.logit_dtype))   # (B, L, V_local)


def sharded_xent(comm: Comm, cfg: ModelConfig, logits, targets):
    """Cross-entropy with the vocabulary sharded over `model`: the
    logsumexp and the target-logit pick each take one small allreduce
    (max, then sum).  Returns the (B, L) token losses."""
    v_local = logits.shape[-1]
    base = comm.axis_index(comm.axes.model) * v_local
    lg = logits.float()
    if cfg.final_softcap is not None:
        lg = cfg.final_softcap * torch.tanh(lg / cfg.final_softcap)
    # no gradient through the stabiliser: the logsumexp's gradient is
    # exact without it, and the max-allreduce needs none
    m_loc = lg.amax(-1).detach()
    m = comm.allreduce(m_loc, comm.axes.model, "max")
    se = torch.exp(lg - m[..., None]).sum(-1)
    se = comm.allreduce(se, comm.axes.model)
    lse = torch.log(se) + m
    loc_t = targets.long() - base
    ok = (loc_t >= 0) & (loc_t < v_local)
    tl = torch.gather(lg, -1, loc_t.clamp(0, v_local - 1)[..., None])[..., 0]
    tl = torch.where(ok, tl, 0.0)
    tl = comm.allreduce(tl, comm.axes.model)
    return lse - tl


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def _gqa_dims(cfg: ModelConfig, tp: int):
    """(q heads per device, kv heads stored per device, kv replicated?).
    Head counts that don't divide tp are padded with 'ghost' q heads whose
    outputs are masked to zero; KV projections are stored replicated when
    n_kv < tp, each device gathering the kv head(s) its q heads map to."""
    nq_local = -(-cfg.n_heads // tp)
    kv_repl = cfg.n_kv_heads < tp or cfg.n_heads % tp != 0
    nkv_store = cfg.n_kv_heads if kv_repl else cfg.n_kv_heads // tp
    return nq_local, nkv_store, kv_repl


def init_attention(gen, cfg: ModelConfig, tp: int, device) -> Params:
    d, hd = cfg.d_model, cfg.hd
    nq_local, nkv_store, _ = _gqa_dims(cfg, tp)
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(cfg.n_heads * hd)
    dt = cfg.param_dtype
    p = {
        "wq": _normal(gen, (d, nq_local * hd), s_in, device, dt),
        "wk": _normal(gen, (d, nkv_store * hd), s_in, device, dt),
        "wv": _normal(gen, (d, nkv_store * hd), s_in, device, dt),
        "wo": _normal(gen, (nq_local * hd, d), s_out, device, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(nq_local * hd, device=device)
        p["bk"] = torch.zeros(nkv_store * hd, device=device)
        p["bv"] = torch.zeros(nkv_store * hd, device=device)
    return p


def layer_window(cfg: ModelConfig, is_local_layer: bool = False):
    """The sliding window a layer attends through: `cfg.local_window` on
    a local layer of a local/global config (gemma2), else `cfg.window`
    (None: no window)."""
    if cfg.local_global_period is not None and is_local_layer:
        return cfg.local_window
    return cfg.window


@functools.lru_cache(maxsize=64)
def _q_kv_heads(cfg: ModelConfig, tp: int, r: int, device):
    """(nq_local,) long on `device`: the kv head each q head of device r
    reads (a ghost q head the last real head's)."""
    nq_local, _, _ = _gqa_dims(cfg, tp)
    group = cfg.n_heads // cfg.n_kv_heads
    return torch.tensor([min(r * nq_local + j, cfg.n_heads - 1) // group
                         for j in range(nq_local)], device=device)


def _local_kv(comm: Comm, cfg: ModelConfig, k, v, tp: int):
    """Per-local-q-head K/V (head-major, (B, H, L, hd)): when the KV
    projection is replicated, each q head's kv group head is gathered
    (any head/kv/tp combination, group of one after); otherwise K/V are
    already the local shard (group attention)."""
    _, _, kv_repl = _gqa_dims(cfg, tp)
    if not kv_repl:
        return k, v
    kv_idx = _q_kv_heads(cfg, tp, comm.axis_index(comm.axes.model),
                         k.device)
    return k.index_select(1, kv_idx), v.index_select(1, kv_idx)


def kv_cache_plan(cfg: ModelConfig, tp: int):
    """The replicated-KV decode cache's static plan (`repro`'s, host
    only): each device stores only the DISTINCT kv heads its q heads
    read, ndk of them (the largest count over the devices; a device with
    fewer repeats its last one), not one copy per q head.  Returns None
    when the KV projection is sharded, else (ndk, store_idx (tp, ndk),
    q2slot (tp, nq_local)) int32: device r stores kv heads store_idx[r]
    and its q head j reads slot q2slot[r, j] (a ghost q head reads the
    last real head's)."""
    nq_local, _, kv_repl = _gqa_dims(cfg, tp)
    if not kv_repl:
        return None
    group = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    store, q2slot = [], []
    for r in range(tp):
        kvs = [min(r * nq_local + j, cfg.n_heads - 1) // group
               for j in range(nq_local)]
        distinct = sorted(set(kvs))
        store.append(distinct)
        q2slot.append([distinct.index(kv) for kv in kvs])
    ndk = max(len(d) for d in store)
    store_idx = np.asarray([d + [d[-1]] * (ndk - len(d)) for d in store],
                           np.int32)
    return ndk, store_idx, np.asarray(q2slot, np.int32)


@functools.lru_cache(maxsize=64)
def _plan_tensors(cfg: ModelConfig, tp: int, r: int, device):
    """Device r's rows of `kv_cache_plan` as long tensors on `device`
    (store_idx, q2slot), or None when the KV projection is sharded; the
    plan is static per (cfg, tp, r), so every layer of every step reuses
    one copy."""
    plan = kv_cache_plan(cfg, tp)
    if plan is None:
        return None
    _, store_idx, q2slot = plan
    return (torch.as_tensor(store_idx[r], dtype=torch.long, device=device),
            torch.as_tensor(q2slot[r], dtype=torch.long, device=device))


@functools.lru_cache(maxsize=64)
def _ghost_mask(cfg: ModelConfig, tp: int, r: int, dtype, device):
    """(nq_local,) of device r: 1 for a real q head, 0 for a ghost."""
    nq_local, _, _ = _gqa_dims(cfg, tp)
    return torch.tensor([r * nq_local + j < cfg.n_heads
                         for j in range(nq_local)], dtype=dtype,
                        device=device)


def _kv_slots(comm: Comm, cfg: ModelConfig, tp: int, k, v):
    """The KV heads a decode cache stores, k and v (B, L, H, hd) -> (k,
    v, q2slot): under `kv_cache_plan` this device's ndk stored heads and
    the (nq_local,) slot each q head reads; otherwise k and v as they
    are (this device's shard) and None."""
    plan = _plan_tensors(cfg, tp, comm.axis_index(comm.axes.model),
                         k.device)
    if plan is None:
        return k, v, None
    sidx, q2slot = plan
    return k.index_select(2, sidx), v.index_select(2, sidx), q2slot


def _zero_ghosts(comm: Comm, cfg: ModelConfig, tp: int, o, head_dim: int):
    """`o` with the ghost q heads' outputs (dim `head_dim`) zeroed, when
    the heads do not divide tp."""
    if cfg.n_heads % tp == 0:
        return o
    mask = _ghost_mask(cfg, tp, comm.axis_index(comm.axes.model), o.dtype,
                       o.device)
    shape = [1] * o.dim()
    shape[head_dim] = mask.numel()
    return o * mask.view(shape)


def attention(comm: Comm, cfg: ModelConfig, p: Params, x, positions, *,
              is_local_layer: bool = False):
    """Full-sequence attention (training): x (B, L, d) replicated over
    `model` -> (B, L, d) replicated, one allreduce over `model`.  This
    device's q heads attend through `ops.attention` (the flash kernel
    forward on the card, a reference-recompute backward) within the
    layer's window (`layer_window`), against their kv heads (gathered
    per q head when the KV projection is replicated); ghost heads are
    zeroed before the output projection.

    `cfg.attention == "ring"` over a data axis of more than one PE is the
    reference's sequence-sharded ring (DESIGN.md §14): the caller shards
    x over `data` by sequence and `positions` are GLOBAL (shared across
    the batch: row 0's are read), and this PE's query shard attends
    against the KV ring of `core.fusion.ring_attention` on the data
    axis's `spmd_ctx` (kernel 6 once a step, each rotation a put_nbi).
    On a data axis of one PE, or on the xla backend, each PE attends its
    own shard, as in the reference."""
    tp = comm.axis_size(comm.axes.model)
    B, L, _ = x.shape
    q, k, v = attention_qkv(cfg, p, x, positions, tp)
    k, v = _local_kv(comm, cfg, k, v, tp)
    window = layer_window(cfg, is_local_layer)
    if (cfg.attention == "ring" and comm.backend == "shmem"
            and comm.axis_size(comm.axes.data) > 1):
        from ..core import fusion, shmem
        pos1 = positions[0].to(torch.int32)[None]     # shared across batch
        o = fusion.ring_attention(
            shmem.spmd_ctx(comm.axes.data), q[None], k[None], v[None], pos1,
            pos1, causal=cfg.causal, window=window, softcap=cfg.softcap,
            out_dtype=q.dtype)[0]
    else:
        o = kops.attention(q, k, v, causal=cfg.causal, window=window,
                           softcap=cfg.softcap)
    o = _zero_ghosts(comm, cfg, tp, o, 1)
    o = o.transpose(1, 2).reshape(B, L, -1).to(cfg.dtype)
    return comm.allreduce(_dense(o, p["wo"]), comm.axes.model)


def attention_qkv(cfg: ModelConfig, p: Params, x, positions, tp: int = 1):
    """The heads `attention` attends over: x (B, L, d) -> q (B, Hq, L,
    hd), k and v (B, Hkv, L, hd) (head-major views; this device's heads
    at `tp`), after the projections and RoPE."""
    B, L, _ = x.shape
    hd = cfg.hd
    nq_local, nkv_store, _ = _gqa_dims(cfg, tp)
    q = _dense(x, p["wq"], p.get("bq")).reshape(B, L, nq_local, hd)
    k = _dense(x, p["wk"], p.get("bk")).reshape(B, L, nkv_store, hd)
    v = _dense(x, p["wv"], p.get("bv")).reshape(B, L, nkv_store, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def init_attn_cache(cfg: ModelConfig, tp: int, batch_local: int,
                    cache_len: int, device, window_bound: int | None = None):
    """A dense KV cache {"k", "v"} of (B, S, K, hd) in cfg.dtype, S =
    min(cache_len, window_bound): a sliding window needs no more slots
    than its width (`attention_decode` then writes it as a ring).  K is
    this device's kv heads at `tp`: its shard, or under the replicated-KV
    plan the ndk distinct heads its q heads read (`kv_cache_plan`)."""
    _, nkv_store, kv_repl = _gqa_dims(cfg, tp)
    if kv_repl:
        nkv_store = kv_cache_plan(cfg, tp)[0]
    s = cache_len if window_bound is None else min(cache_len, window_bound)
    shape = (batch_local, s, nkv_store, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def attention_decode(comm: Comm, cfg: ModelConfig, p: Params, x, cache,
                     position, *, is_local_layer: bool = False,
                     seq_shards: int = 1):
    """One-token decode against a dense KV cache: x (B, 1, d), position
    (B,) -> ((B, 1, d), cache).

    The new K/V row is written into `cache` in place (the reference
    returns a new cache through `dynamic_update_slice`; a copy of a
    long-context cache per layer per step is not what a server runs) and
    the cache is returned.  The layer's window is `layer_window`'s.  A
    windowed cache no longer than its window is a ring: position t lands
    in slot t % S and a slot is valid when the position it holds is at
    most t.  Attends through `_cache_attend`.  At tp > 1 this device's
    heads attend against its cache (`init_attn_cache` at that tp: under
    the replicated-KV plan it stores the new row's `kv_cache_plan` heads
    and each q head reads its slot), the ghost heads are zeroed, and the
    output projection ends in one allreduce over `model`.

    With seq_shards > 1 the cache's sequence is sharded over `data` (the
    long-context decode of a batch below the data size; `x` and
    `position` are the same on every data PE): this PE's S slots hold
    global rows [shard S, shard S + S), only the PE that owns the new row
    writes it, a row is valid up to the position and within the window
    (the ring of a windowed cache is not used here, as in the reference:
    its min(cache_len / seq_shards, window) slots a PE cover positions
    below seq_shards x window), and the partial softmax statistics are
    combined over `data` (`_attend_mq`'s allreduces: a max, then two
    sums)."""
    tp = comm.axis_size(comm.axes.model)
    B = x.shape[0]
    q, k, v = (t.transpose(1, 2)                         # (B, 1, H, hd)
               for t in attention_qkv(cfg, p, x, position[:, None], tp))
    k, v, q2slot = _kv_slots(comm, cfg, tp, k, v)
    S = cache["k"].shape[1]
    window = layer_window(cfg, is_local_layer)
    rows = torch.arange(B, device=x.device)
    pos = position[:, None]
    if seq_shards == 1:
        ring = window is not None and S <= window
        # past the last slot the write lands in it, as
        # dynamic_update_slice clamps its start
        slot = position % S if ring else position.clamp(max=S - 1)
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        pos_idx = torch.arange(S, device=x.device)[None, :]
        combine = None
    else:
        g_start = comm.axis_index(comm.axes.data) * S
        slot = position - g_start
        here = ((slot >= 0) & (slot < S))[:, None, None]
        slot = slot.clamp(0, S - 1)
        for name, new_row in (("k", k), ("v", v)):   # the owner writes
            c = cache[name]
            c[rows, slot] = torch.where(here, new_row[:, 0].to(c.dtype),
                                        c[rows, slot])
        pos_idx = g_start + torch.arange(S, device=x.device)[None, :]
        ring, combine = False, comm
    if ring:
        age = pos - ((pos - pos_idx) % S)
        valid = (age >= 0) & (age <= pos)
    else:
        valid = pos_idx <= pos
        if window is not None:
            valid &= pos_idx > (pos - window)
    out = _cache_attend(cfg, q, cache["k"], cache["v"], valid, q2slot,
                        combine)
    out = _zero_ghosts(comm, cfg, tp, out, 2)
    out = out.reshape(B, 1, -1).to(cfg.dtype)
    y = _dense(out, p["wo"])
    return comm.allreduce(y, comm.axes.model), cache


def _cache_attend(cfg, q, ck, cv, valid, q2slot=None, comm=None):
    """q: (B,1,Hq,hd); ck/cv: (B,S,K,hd); valid: (B,S) -> (B,1,Hq,hd):
    `repro.models.layers._cache_attend` in f32, grouped GQA, or with
    `q2slot` the replicated-KV plan's slot of each q head; with `comm`,
    the statistics of a cache sharded over its data axis combined there
    (see `_attend_mq`)."""
    return _attend_mq(cfg, q, ck, cv, valid[:, None, :], q2slot, comm)


# ---------------------------------------------------------------------------
# MLA (deepseek-v3): latent KV, cache = compressed c_kv (+ rope key)
# ---------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig, tp: int, device) -> Params:
    m = cfg.mla
    d = cfg.d_model
    nq_local = cfg.n_heads // tp
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    dt = cfg.param_dtype

    def nrm(shape, fan_in):
        return _normal(gen, shape, 1.0 / math.sqrt(fan_in), device, dt)

    return {
        "wq_a": nrm((d, m.q_lora_rank), d),
        "wq_b": nrm((m.q_lora_rank, nq_local * qk_dim), m.q_lora_rank),
        "wkv_a": nrm((d, m.kv_lora_rank + m.qk_rope_dim), d),
        "wkv_b": nrm((m.kv_lora_rank, nq_local * (m.qk_nope_dim + m.v_dim)),
                     m.kv_lora_rank),
        "wo": nrm((nq_local * m.v_dim, d), cfg.n_heads * m.v_dim),
        "q_norm": torch.zeros(m.q_lora_rank, device=device),
        "kv_norm": torch.zeros(m.kv_lora_rank, device=device),
    }


def _mla_q(cfg: ModelConfig, p: Params, x, positions):
    """MLA's query heads: x (B, L, d), positions (B, L) -> q_nope (B, L,
    H, nope) and q_rope (B, L, H, rope), RoPE applied."""
    m = cfg.mla
    B, L, _ = x.shape
    cq = rms_norm(_dense(x, p["wq_a"]), p["q_norm"])
    q = _dense(cq, p["wq_b"]).reshape(B, L, -1,
                                      m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(cfg: ModelConfig, p: Params, x, positions):
    """MLA's compressed KV: x (B, L, d) -> c_kv (B, L, kv_lora_rank),
    normed, and k_rope (B, L, 1, rope), the one RoPE key all heads
    share."""
    m = cfg.mla
    kv_a = _dense(x, p["wkv_a"])
    c_kv = rms_norm(kv_a[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = rope(kv_a[..., None, m.kv_lora_rank:], positions,
                  cfg.rope_theta)
    return c_kv, k_rope


def mla_attention(comm: Comm, cfg: ModelConfig, p: Params, x, positions):
    """Full-sequence MLA (prefill, training): x (B, L, d) -> (B, L, d).
    The latent KV is expanded to every head's k (k_nope, then the shared
    k_rope) and v, and attends through `ops.attention` at head dim nope +
    rope against a v head dim of its own, scaled by 1/sqrt(nope + rope).
    At tp > 1 this device holds n_heads / tp q heads (`wq_b`, `wkv_b`
    and `wo` split by head, `wq_a`, `wkv_a` and the norms replicated)
    and the output projection ends in one allreduce over `model`."""
    m = cfg.mla
    B, L, _ = x.shape
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    kv = _dense(c_kv, p["wkv_b"]).reshape(B, L, -1,
                                          m.qk_nope_dim + m.v_dim)
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    H = k_nope.shape[2]
    k = torch.cat([k_nope, k_rope.expand(B, L, H, m.qk_rope_dim)], -1)
    qf = torch.cat([q_nope, q_rope], -1)
    o = kops.attention(
        qf.transpose(1, 2), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2), causal=True,
        sm_scale=1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim))
    o = o.transpose(1, 2).reshape(B, L, H * m.v_dim)
    return comm.allreduce(_dense(o.to(cfg.dtype), p["wo"]), comm.axes.model)


def init_mla_cache(cfg: ModelConfig, batch_local: int, cache_len: int,
                   device):
    """MLA's decode cache: {"c_kv": (B, S, kv_lora_rank), "k_rope": (B,
    S, rope)} in cfg.dtype."""
    m = cfg.mla
    return {"c_kv": torch.zeros((batch_local, cache_len, m.kv_lora_rank),
                                dtype=cfg.dtype, device=device),
            "k_rope": torch.zeros((batch_local, cache_len, m.qk_rope_dim),
                                  dtype=cfg.dtype, device=device)}


def mla_decode(comm: Comm, cfg: ModelConfig, p: Params, x, cache, position):
    """One-token MLA decode: x (B, 1, d), position (B,) -> ((B, 1, d),
    cache).  The new latent row is written into `cache` in place at
    position.clamp(max=S - 1) (where dynamic_update_slice clamps its
    start), then the reference's absorbed attention runs in f32: the
    score is q_nope . (W_kb^T c_kv) + q_rope . k_rope, the context is
    read from c_kv and expanded through W_vb.  At tp > 1 on this
    device's n_heads / tp heads (the latent cache is replicated), with
    one allreduce over `model` after the output projection."""
    m = cfg.mla
    B = x.shape[0]
    pos = position[:, None]
    q_nope, q_rope = _mla_q(cfg, p, x, pos)
    c_kv, k_rope = _mla_latent(cfg, p, x, pos)
    ckv, ckr = cache["c_kv"], cache["k_rope"]
    S = ckv.shape[1]
    rows = torch.arange(B, device=x.device)
    slot = position.clamp(max=S - 1)
    ckv[rows, slot] = c_kv[:, 0].to(ckv.dtype)
    ckr[rows, slot] = k_rope[:, 0, 0].to(ckr.dtype)

    H = q_nope.shape[2]
    wkv = p["wkv_b"].reshape(m.kv_lora_rank, H, m.qk_nope_dim + m.v_dim)
    w_k = wkv[..., :m.qk_nope_dim].float()             # (r, h, nope)
    w_v = wkv[..., m.qk_nope_dim:].float()             # (r, h, v)
    ckv32 = ckv.float()
    q_abs = torch.einsum("bohn,rhn->bohr", q_nope.float(), w_k)
    sc = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    logits = (torch.einsum("bohr,bsr->bhs", q_abs, ckv32)
              + torch.einsum("bohn,bsn->bhs", q_rope.float(),
                             ckr.float())) * sc
    valid = torch.arange(S, device=x.device)[None, :] <= pos
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    pr = torch.softmax(logits, -1)
    ctx = torch.einsum("bhs,bsr->bhr", pr, ckv32)
    o = torch.einsum("bhr,rhv->bhv", ctx, w_v)
    o = o.reshape(B, 1, H * m.v_dim).to(cfg.dtype)
    y = comm.allreduce(_dense(o, p["wo"]), comm.axes.model)
    return y, cache


# ---------------------------------------------------------------------------
# Paged KV attention (serving engine)
# ---------------------------------------------------------------------------

def paged_kv_update(pool_leaf, page_table, new, positions, page_size: int):
    """Scatter per-position rows into a paged KV pool, in place.

    pool_leaf: (num_pages, page_size, ...) — one layer's page pool;
    page_table: (B, max_pages) int64 physical page ids (0 = null page);
    new: (B, L, ...) rows to write; positions: (B, L) global positions.
    Rows land at pool[page_table[b, pos // page_size], pos % page_size].
    Distinct sequences own distinct pages, so batched writes never
    collide except on the reserved null page, whose contents no valid
    read sees.  Returns pool_leaf."""
    page = positions // page_size
    off = positions % page_size
    phys = torch.gather(page_table, 1, page)                 # (B, L)
    pool_leaf[phys, off] = new.to(pool_leaf.dtype)
    return pool_leaf


def _attend_mq(cfg, q, ck, cv, valid, q2slot=None, comm=None):
    """Multi-query attention against a gathered cache, plain torch in f32
    (`kernels.ref.mq_attention_ref`, the reference's arithmetic).

    q: (B,L,Hq,hd); ck/cv: (B,S,K,hd); valid: (B,L,S) -> (B,L,Hq,hd).
    Grouped GQA, or with `q2slot` (Hq,) the replicated-KV plan.  Every op
    is per row, so a row's result does not depend on the other rows of
    the batch (the engine's batched-vs-alone bit-identity).  With `comm`
    the cache is one shard of a sequence split over `comm`'s data axis
    (flash-decode on the shmem collectives, as the reference): the max of
    the logits is allreduced ("max") there before the exponentials, then
    the denominators and the weighted sums of v are summed there; a shard
    with no valid row adds zeros."""
    allreduce = None if comm is None else \
        (lambda t, op: comm.allreduce(t, comm.axes.data, op))
    return kref.mq_attention_ref(q, ck, cv, valid, softcap=cfg.softcap,
                                 q2slot=q2slot, allreduce=allreduce)


def check_prefill_positions(positions):
    """Raise unless positions (B, L) are arange(L) in every row, the only
    positions paged prefill takes.  Reads the tensor back to the host."""
    B, L = positions.shape
    arange = torch.arange(L, device=positions.device)
    if not torch.equal(positions, arange.expand(B, L)):
        raise ValueError("paged prefill needs positions = arange(L) in "
                         "every row")


def attention_paged(comm: Comm, cfg: ModelConfig, p: Params, x, pool,
                    page_table, positions, *, page_size: int,
                    is_local_layer: bool = False,
                    positions_checked: bool = False, decode_rows=None):
    """GQA attention against a paged KV pool, for prefill (x: (B, L, d),
    L = prompt bucket) and decode (L = 1).

    pool: {"k","v"} (num_pages, page_size, K, hd), updated in place;
    page_table: (B, max_pages) physical page ids.  K/V rows of every
    position are scattered into the owning page (`layer.attn.kv`).
    Prefill gathers each row's pages back sequence-contiguous and must
    come with positions = arange(L) in every row: its causal(+window)
    mask, the window `layer_window`'s, is then the flash kernel's
    `k_pos <= q_pos`, and it attends through `ops.attention`.  The
    positions are checked here unless the caller has checked them
    (`positions_checked`, as `prefill_paged` does once for the whole
    stack).  Decode attends through `kernels.paged_decode`, which reads
    each row's live pages in place on the card (on the CPU its plain
    version gathers them and attends as the reference's `_attend_mq`),
    with the step's `decode_rows` where the caller made them once for
    the stack (`paged_decode.decode_rows`, as `_paged_model` does).
    At tp > 1 the pool holds this device's kv heads (`init_attn_cache`
    at that tp); under the replicated-KV plan it stores
    `kv_cache_plan`'s heads, and the prefill hands the kernel K and V
    expanded to one head per local q head through q2slot (group 1, as
    `_local_kv` does in training) while the decode reads each q head's
    slot; the ghost heads are zeroed and the output projection ends in
    one allreduce over `model`."""
    tp = comm.axis_size(comm.axes.model)
    B, L, d = x.shape
    hd = cfg.hd
    nq_local, nkv_store, _ = _gqa_dims(cfg, tp)
    prof = comm.profile
    with region(prof, "layer.attn.qkv"):
        q = _dense(x, p["wq"], p.get("bq")).reshape(B, L, nq_local, hd)
        k = _dense(x, p["wk"], p.get("bk")).reshape(B, L, nkv_store, hd)
        v = _dense(x, p["wv"], p.get("bv")).reshape(B, L, nkv_store, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        k, v, q2slot = _kv_slots(comm, cfg, tp, k, v)

    with region(prof, "layer.attn.kv"):
        paged_kv_update(pool["k"], page_table, k, positions, page_size)
        paged_kv_update(pool["v"], page_table, v, positions, page_size)
        if L > 1:
            ck = paged_kv_gather(pool["k"], page_table)      # (B,S_max,K,hd)
            cv = paged_kv_gather(pool["v"], page_table)

    with region(prof, "layer.attn.core"):
        window = layer_window(cfg, is_local_layer)
        if L > 1:
            if not positions_checked:
                check_prefill_positions(positions)
            if q2slot is not None:      # one kv head per local q head
                ck = ck.index_select(2, q2slot)
                cv = cv.index_select(2, q2slot)
            out = kops.attention(
                q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2),
                causal=True, window=window, softcap=cfg.softcap,
                sm_scale=1.0 / math.sqrt(hd)).transpose(1, 2)
        else:
            out = kpd.paged_decode_attention(
                q[:, 0], pool["k"], pool["v"], page_table, positions[:, 0],
                page_size=page_size, window=window, softcap=cfg.softcap,
                q2slot=q2slot, rows=decode_rows)[:, None]

    with region(prof, "layer.attn.out"):
        out = _zero_ghosts(comm, cfg, tp, out, 2)
        out = out.reshape(B, L, nq_local * hd).to(cfg.dtype)
        y = _dense(out, p["wo"])
        return comm.allreduce(y, comm.axes.model), pool


# ---------------------------------------------------------------------------
# MLP (dense swiglu)
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, tp: int, device,
             d_ff: int | None = None) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    ff_local = ff // tp
    dt = cfg.param_dtype
    return {
        "w_gate": _normal(gen, (d, ff_local), 1.0 / math.sqrt(d), device,
                          dt),
        "w_up": _normal(gen, (d, ff_local), 1.0 / math.sqrt(d), device, dt),
        "w_down": _normal(gen, (ff_local, d), 1.0 / math.sqrt(ff), device,
                          dt),
    }


def _silu(x):
    """silu of the MLP and expert gates: `F.silu` on the card; on the CPU
    x / (1 + exp(-x)), every element by the same arithmetic.  The CPU
    build's vectorized `F.silu` (and `torch.sigmoid`) computes the tail
    of a tensor whose size is not a multiple of its unrolled vector width
    in a path of its own whose last bits differ, so a row's result would
    depend on the rows beside it (an engine slot); exp and the division
    have no such tail.  A 16-bit x is computed in f32 and rounded once,
    as `F.silu` does."""
    if x.device.type != "cpu":
        return F.silu(x)
    xf = x.float() if x.element_size() < 4 else x
    return (xf / (1.0 + torch.exp(-xf))).to(x.dtype)


def mlp(comm: Comm, cfg: ModelConfig, p: Params, x):
    h = _silu(_dense(x, p["w_gate"])) * _dense(x, p["w_up"])
    return comm.allreduce(_dense(h, p["w_down"]), comm.axes.model)


# ---------------------------------------------------------------------------
# MoE (expert parallel over `model`, alltoall dispatch)
# ---------------------------------------------------------------------------

def moe_ep_size(cfg: ModelConfig, tp: int, dp: int) -> int:
    return tp * dp if cfg.moe.ep_over_data else tp


def init_moe(gen, cfg: ModelConfig, tp: int, device, dp: int = 1) -> Params:
    """The router (d, E), the routed experts' SwiGLU weights w_gate,
    w_up (E_local, d, f) and w_down (E_local, f, d), and with n_shared
    the shared experts as one MLP of n_shared * f."""
    mo = cfg.moe
    d = cfg.d_model
    e_local = -(-mo.n_experts // moe_ep_size(cfg, tp, dp))
    dt = cfg.param_dtype

    def nrm(shape, fan):
        return _normal(gen, shape, 1.0 / math.sqrt(fan), device, dt)

    p = {
        "router": nrm((d, mo.n_experts), d),
        "w_gate": nrm((e_local, d, mo.d_ff), d),
        "w_up": nrm((e_local, d, mo.d_ff), d),
        "w_down": nrm((e_local, mo.d_ff, d), mo.d_ff),
    }
    if mo.n_shared:
        p["shared"] = init_mlp(gen, cfg, tp, device,
                               d_ff=mo.n_shared * mo.d_ff)
    return p


def moe_route(cfg: ModelConfig, p: Params, xs):
    """Top-k routing with capacity dropping over the tokens xs (T, d):
    (gates (T, E) f32, topv (T, K) renormalised, tope (T, K), slot (T*K,)
    each pick's rank among its expert's picks in token-major order, keep
    (T*K,) whether that rank is under the capacity, cap)."""
    mo = cfg.moe
    t_local = xs.shape[0]
    gates = torch.softmax(_dense(xs, p["router"]).float(), -1)   # (T, E)
    topv, tope = torch.topk(gates, mo.top_k, dim=-1, sorted=True)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = max(1, int(mo.capacity_factor * t_local * mo.top_k
                     / mo.n_experts))
    e_flat = tope.reshape(-1)                                   # (T*K,)
    # the one-hot held expert-major, (E, T*K), so that the cumulative sum
    # runs along its contiguous dim: over the outer dim of a (T*K, E)
    # one-hot the same sum took 2.84 s of granite-moe's 3.79 s prefill of
    # 32768 tokens on an H100 (tools/profile_prefill)
    onehot = torch.zeros((mo.n_experts, e_flat.shape[0]), dtype=torch.int32,
                         device=xs.device).scatter_(0, e_flat[None], 1)
    ranks = onehot.cumsum(1, dtype=torch.int32) - 1
    del onehot
    slot = ranks.gather(0, e_flat[None])[0].long()
    return gates, topv, tope, slot, slot < cap, cap


def moe_tokens(comm: Comm, x):
    """This device's slice of the MoE layer's tokens: x (B, L, d), the
    same on every PE of `model`, flattened to (B * L, d), padded with
    zero tokens to a multiple of tp (a decode step can carry fewer
    tokens than tp: the pads route, and are dropped on the way back) and
    cut into tp slices."""
    tp = comm.axis_size(comm.axes.model)
    flat = x.reshape(-1, x.shape[-1])
    t_pad = -(-flat.shape[0] // tp) * tp
    if t_pad != flat.shape[0]:
        flat = F.pad(flat, (0, 0, 0, t_pad - flat.shape[0]))
    t_local = t_pad // tp
    my = comm.axis_index(comm.axes.model)
    return flat[my * t_local:(my + 1) * t_local]


def moe(comm: Comm, cfg: ModelConfig, p: Params, x):
    """x: (B, L, d) -> (out (B, L, d), aux), `repro.models.layers.moe`
    step by step.

    Capacity is per call: cap = max(1, int(capacity_factor * T * top_k /
    n_experts)) over this call's T tokens, so a decode step of B tokens
    routes at capacity max(1, ...) and drops most picks, as the reference
    does.  The picks are assigned into the (E, C, d) dispatch buffer by a
    scatter of fixed shape (every pick has a row: a kept one its (expert,
    slot) row, which holds exactly one token, so the assignment is
    deterministic and equals the reference's scatter-add; a dropped one a
    sink row past the buffer, sliced off), so no shape depends on the
    routes and the host never waits on them; then exchanged
    by `Comm.alltoall` over the EP group, run through the
    experts as batched products in the activation dtype, and combined in
    f32 as an in-order sum over k of each pick's rows times its weight;
    the shared experts are added after.  aux is the load-balance loss E *
    sum(mean(gates) * mean(picks per expert)).

    At ep > 1 (the reference's dispatch): the tokens are split over
    `model` (padded with zero tokens to a multiple of tp), each device
    routes its own slice with the capacity of that slice, the E_pad =
    e_local * ep slots (padded experts get no picks) go to their owners
    and come back by two alltoalls over the EP group, and the token
    slices are allgathered over `model`; aux is this device's, from its
    own gates."""
    mo = cfg.moe
    ep_axes = ((comm.axes.data, comm.axes.model) if mo.ep_over_data
               else comm.axes.model)
    ep = (math.prod(comm.axis_size(a) for a in ep_axes)
          if isinstance(ep_axes, tuple) else comm.axis_size(ep_axes))
    B, L, d = x.shape
    e_local = -(-mo.n_experts // ep)
    e_pad = e_local * ep

    # 1. this device's token slice of the model group
    xs = moe_tokens(comm, x)
    t_total, t_local = B * L, xs.shape[0]

    # 2-3. route, capacity, dispatch of the kept picks into (E_pad, C, d)
    gates, topv, tope, slot, keep, cap = moe_route(cfg, p, xs)
    e_flat = tope.reshape(-1)
    tok_idx = torch.arange(t_local, device=x.device).repeat_interleave(
        mo.top_k)
    rows = torch.where(keep, e_flat * cap + slot, e_pad * cap)
    disp = x.new_zeros((e_pad * cap + 1, d)).index_put(
        (rows,), xs[tok_idx])[:-1].reshape(e_pad, cap, d)

    # 4. alltoall over the EP group: (E_pad, C, d) -> (e_local, ep*C, d)
    a2a = comm.alltoall(disp.reshape(ep, e_local * cap, d), ep_axes,
                        split_axis=0, concat_axis=0)
    del disp
    exp_in = a2a.reshape(ep, e_local, cap, d).transpose(0, 1) \
        .reshape(e_local, ep * cap, d)

    # 5. expert FFN
    h = _silu(torch.bmm(exp_in, p["w_gate"].to(x.dtype))) \
        * torch.bmm(exp_in, p["w_up"].to(x.dtype))
    del exp_in, a2a
    y = torch.bmm(h, p["w_down"].to(x.dtype))
    del h

    # 6. alltoall back, then the weighted combine in f32, pick by pick
    y = y.reshape(e_local, ep, cap, d).transpose(0, 1) \
        .reshape(ep, e_local * cap, d)
    buf = comm.alltoall(y, ep_axes, split_axis=0,
                        concat_axis=0).reshape(e_pad, cap, d)
    del y
    keep2 = keep.reshape(t_local, mo.top_k)
    e_idx = torch.where(keep, e_flat, 0).reshape(t_local, mo.top_k)
    s_idx = torch.where(keep, slot, 0).reshape(t_local, mo.top_k)
    w = (topv * keep2).float()
    ys = torch.zeros((t_local, d), dtype=torch.float32, device=x.device)
    for k in range(mo.top_k):
        got = torch.where(keep2[:, k, None], buf[e_idx[:, k], s_idx[:, k]],
                          0.0)
        ys = ys + got.float() * w[:, k, None]
    del buf

    # 7. allgather the token slices back to the model-replicated layout
    full = comm.allgather(ys.to(x.dtype), comm.axes.model, concat_axis=0)
    out = full[:t_total].reshape(B, L, d)
    if mo.n_shared:
        out = out + mlp(comm, cfg, p["shared"], x)
    # load-balance aux loss (training)
    me = gates.mean(0)
    ce = torch.zeros(mo.n_experts, dtype=torch.int64, device=x.device) \
        .index_add_(0, e_flat, torch.ones_like(e_flat)).float() / t_local
    aux = mo.n_experts * (me * ce).sum()
    return out, aux


# ---------------------------------------------------------------------------
# Mamba2 block (ssm family)
# ---------------------------------------------------------------------------

def init_mamba2(gen, cfg: ModelConfig, tp: int, device) -> Params:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    d_in_local = d_in // tp
    nheads_local = d_in_local // s.head_dim
    conv_dim = d_in_local + 2 * s.n_groups * s.state
    dt = cfg.param_dtype
    return {
        # [z, x, B, C, dt] fused in-proj
        "w_in": _normal(gen, (d, 2 * d_in_local + 2 * s.n_groups * s.state
                              + nheads_local), 1.0 / math.sqrt(d), device,
                        dt),
        "conv_w": _normal(gen, (s.conv_width, conv_dim),
                          1.0 / math.sqrt(s.conv_width), device, dt),
        "conv_b": torch.zeros(conv_dim, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nheads_local,
                                          device=device)),
        "dt_bias": torch.zeros(nheads_local, device=device),
        "d_skip": torch.ones(nheads_local, device=device),
        "norm_w": torch.zeros(d_in_local, device=device),
        "w_out": _normal(gen, (d_in_local, d), 1.0 / math.sqrt(d_in),
                         device, dt),
    }


def _mamba_split(cfg: ModelConfig, tp: int):
    s = cfg.ssm
    d_in_local = s.expand * cfg.d_model // tp
    nheads_local = d_in_local // s.head_dim
    gdim = s.n_groups * s.state
    return d_in_local, nheads_local, gdim


def mamba2(comm: Comm, cfg: ModelConfig, p: Params, x):
    """Full-sequence Mamba2 (prefill, training): x (B, L, d) -> (B, L,
    d), one allreduce at the out-projection; at tp > 1 on this device's
    SSM heads (`_mamba_split`).  The causal depthwise conv is the
    reference's shifted sum in the activation dtype; x, B and C reach
    `ops.ssd` as views of the conv's output (no copy)."""
    s = cfg.ssm
    tp = comm.axis_size(comm.axes.model)
    B, seq, _ = x.shape
    d_in_local, nheads_local, gdim = _mamba_split(cfg, tp)

    zxbcdt = _dense(x, p["w_in"])
    z = zxbcdt[..., :d_in_local]
    xbc = zxbcdt[..., d_in_local:d_in_local * 2 + 2 * gdim]
    dt = zxbcdt[..., -nheads_local:]

    # depthwise causal conv over [x, B, C]
    w = p["conv_w"].to(xbc.dtype)
    acc = xbc * w[-1]
    for i in range(1, s.conv_width):
        acc = acc + F.pad(xbc, (0, 0, i, 0))[:, :seq] * w[-1 - i]
    xbc = F.silu(acc + p["conv_b"].to(acc.dtype))

    xs = xbc[..., :d_in_local].reshape(B, seq, nheads_local, s.head_dim)
    b_mat = xbc[..., d_in_local:d_in_local + gdim] \
        .reshape(B, seq, s.n_groups, s.state)
    c_mat = xbc[..., d_in_local + gdim:] \
        .reshape(B, seq, s.n_groups, s.state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())

    y, _ = kops.ssd(xs, dt, a, b_mat, c_mat, chunk=s.chunk)
    y = y + xs * p["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, seq, d_in_local)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm_w"])
    out = _dense(y.to(cfg.dtype), p["w_out"])
    return comm.allreduce(out, comm.axes.model)


def init_mamba_cache(cfg: ModelConfig, tp: int, batch_local: int, device):
    s = cfg.ssm
    d_in_local, nheads_local, gdim = _mamba_split(cfg, tp)
    conv_dim = d_in_local + 2 * gdim
    return {
        "conv": torch.zeros((batch_local, s.conv_width - 1, conv_dim),
                            dtype=cfg.dtype, device=device),
        "ssm": torch.zeros((batch_local, nheads_local, s.head_dim, s.state),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(comm: Comm, cfg: ModelConfig, p: Params, x, cache):
    """One-step recurrence (decode): x (B, 1, d) -> ((B, 1, d), new
    cache).  The conv history and the state come back as new tensors.
    At tp > 1 on this device's SSM heads (`_mamba_split`; its cache is
    `init_mamba_cache` at that tp), one allreduce over `model`."""
    s = cfg.ssm
    tp = comm.axis_size(comm.axes.model)
    B = x.shape[0]
    d_in_local, nheads_local, gdim = _mamba_split(cfg, tp)

    zxbcdt = _dense(x[:, 0], p["w_in"])                     # (B, ...)
    z = zxbcdt[..., :d_in_local]
    xbc = zxbcdt[..., d_in_local:d_in_local * 2 + 2 * gdim]
    dt = zxbcdt[..., -nheads_local:]

    conv_hist = torch.cat([cache["conv"], xbc[:, None].to(cfg.dtype)], 1)
    w = p["conv_w"].float()
    acc = torch.einsum("bwc,wc->bc", conv_hist.float(), w)
    xbc = F.silu(acc + p["conv_b"].float())

    xs = xbc[..., :d_in_local].reshape(B, nheads_local, s.head_dim)
    b_t = xbc[..., d_in_local:d_in_local + gdim].reshape(B, s.n_groups,
                                                         s.state)
    c_t = xbc[..., d_in_local + gdim:].reshape(B, s.n_groups, s.state)
    group = nheads_local // s.n_groups
    b_h = b_t.repeat_interleave(group, 1)
    c_h = c_t.repeat_interleave(group, 1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = torch.exp(-torch.exp(p["a_log"].float())[None] * dt)
    state = cache["ssm"] * a[..., None, None] + (
        dt[..., None, None] * xs[..., None].float()
        * b_h[..., None, :].float())
    y = torch.einsum("bhn,bhpn->bhp", c_h.float(), state)
    y = y + xs.float() * p["d_skip"][None, :, None]
    y = y.reshape(B, d_in_local)
    y = rms_norm(y * F.silu(z.float()), p["norm_w"])
    out = _dense(y[:, None].to(cfg.dtype), p["w_out"])
    out = comm.allreduce(out, comm.axes.model)
    return out, {"conv": conv_hist[:, 1:], "ssm": state}
