"""Kernel 6's plain version and wrapper, the partial-state merge, the
port's ring attention on the SIM (plain and NoC waves) and its pricing,
on the CPU against the JAX package on the same numpy inputs.

The port is held to `repro.kernels.ring_attention.attn_block_partials`
(`_partials_ref`) at rtol 1e-4, atol 1e-5, and its ring attention to
`repro.core.fusion.ring_attention(use_pallas=False)` and to the port's
monolithic `ops.attention` at `tests/test_fused.py`'s 2e-5.  The
reference's Pallas partials are not used: they are red under this JAX
(no `pl.load`).  `choose_attention` must equal the reference exactly."""
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.core import fusion as jfusion
from repro.core import shmem as jshmem
from repro.core.topology import epiphany3 as jepiphany3
from repro.kernels import ring_attention as jra
from repro.models import layers as JL
from repro.parallel.comm import AxisSpec as JAxisSpec
from repro.parallel.comm import Comm as JComm
from repro_torch.configs import smoke_config
from repro_torch.core import fusion, sim_ctx
from repro_torch.core.netops import NetOps
from repro_torch.core.topology import epiphany3
from repro_torch.kernels import ops, ref
from repro_torch.kernels import put_copy as pc
from repro_torch.kernels import ring_attention as ra
from repro_torch.models import layers as L

TOL = dict(rtol=1e-4, atol=1e-5)
RING_ATOL = 2e-5                      # tests/test_fused.py's bound
NEG_INF = -1e30


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _block(seed, b, hq, hkv, lq, lk, d, q0=0, k0=0, pad=0):
    """q, k, v (f32) and global positions: query rows at q0.., key slots
    at k0.., the last `pad` key slots marked -1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, lk, d)).astype(np.float32)
    q_pos = np.arange(q0, q0 + lq, dtype=np.int32)
    k_pos = np.arange(k0, k0 + lk, dtype=np.int32)
    if pad:
        k_pos[-pad:] = -1
    return q, k, v, q_pos, k_pos


def _jax_partials(q, k, v, q_pos, k_pos, **kw):
    return jra.attn_block_partials(*map(jnp.asarray, (q, k, v, q_pos, k_pos)),
                                   use_pallas=False, **kw)


# (label, Hq, Hkv, Lq, Lk, D, q0, k0, pad, options): causal diagonal and
# off-diagonal blocks, window, softcap, GQA groups 1 to 7, -1 slots, and
# Lq/Lk that are not multiples of the kernel's 32/64 tiles
BLOCKS = [
    ("diag", 4, 4, 32, 32, 16, 0, 0, 0, dict(causal=True)),
    ("past", 4, 2, 24, 40, 16, 40, 0, 0, dict(causal=True)),
    ("noncausal", 4, 1, 20, 33, 32, 0, 100, 0, dict(causal=False)),
    ("window", 6, 2, 37, 45, 16, 30, 10, 0, dict(causal=True, window=12)),
    ("softcap", 2, 2, 16, 70, 16, 60, 0, 0, dict(causal=True, softcap=3.0)),
    ("pad", 7, 1, 13, 29, 16, 20, 0, 5, dict(causal=True)),
    ("all", 4, 2, 33, 65, 16, 40, 30, 9,
     dict(causal=True, window=20, softcap=5.0)),
]


@pytest.mark.parametrize("case", BLOCKS, ids=[c[0] for c in BLOCKS])
def test_partials_match_jax(case):
    _, hq, hkv, lq, lk, d, q0, k0, pad, kw = case
    a = _block(1, 2, hq, hkv, lq, lk, d, q0, k0, pad)
    want = _jax_partials(*a, **kw)
    for got in (ref.ring_partials_ref(*map(t, a), **kw),
                ra.attn_block_partials(*map(t, a), **kw)):
        for g, w in zip(got, want):
            close(g, w)


def test_partials_stacked_pe_axis_matches_per_pe_jax():
    """The SIM's leading PE axis: one call over P PEs, each PE with its
    own position tables, equals the reference per PE."""
    blocks = [_block(7 + p, 2, 4, 2, 19, 23, 16, q0=8 * p, k0=10 * p,
                     pad=p) for p in range(3)]
    stacked = [np.stack(x) for x in zip(*blocks)]
    kw = dict(causal=True, window=15, softcap=4.0)
    got = ra.attn_block_partials(*map(t, stacked), **kw)
    for p, blk in enumerate(blocks):
        for g, w in zip(got, _jax_partials(*blk, **kw)):
            close(g[p], w)


@pytest.mark.parametrize("pad", [0, 3])
def test_wholly_masked_rows_follow_the_reference(pad):
    """A block in the future of every row: m exactly -1e30, l = Lk (every
    slot, -1 ones too, weighs exp(0) = 1), acc = the sum of v."""
    a = _block(2, 1, 4, 2, 16, 37, 16, q0=0, k0=100, pad=pad)
    acc, m, l = ra.attn_block_partials(*map(t, a), causal=True)
    jacc, jm, jl = _jax_partials(*a, causal=True)
    assert (m == NEG_INF).all() and np.all(np.asarray(jm) == NEG_INF)
    assert (l == 37.0).all() and np.all(np.asarray(jl) == 37.0)
    vsum = np.repeat(a[2].sum(2), 2, axis=1)[:, :, None, :]
    close(acc, np.broadcast_to(vsum, acc.shape))
    close(acc, jacc)


def test_merge_and_finalize_match_jax():
    """Merges in both orders, one partial wholly masked: it is wiped, and
    finalize (the max(l, 1e-30) guard) equals the reference."""
    kept = _block(3, 1, 4, 2, 16, 24, 16, q0=30, k0=0)
    future = _block(3, 1, 4, 2, 16, 24, 16, q0=30, k0=60)
    partly = _block(4, 1, 4, 2, 16, 24, 16, q0=30, k0=20)
    pt = [ra.attn_block_partials(*map(t, blk)) for blk in
          (kept, future, partly)]
    pj = [_jax_partials(*blk, causal=True) for blk in (kept, future, partly)]
    for i, j in ((0, 1), (1, 0), (0, 2), (2, 1)):
        got = ra.merge_partials(pt[i], pt[j])
        want = jra.merge_partials(pj[i], pj[j])
        for g, w in zip(got, want):
            close(g, w)
        close(ra.finalize(got), jra.finalize(want))
    wiped = ra.merge_partials(pt[1], pt[0])
    for g, w in zip(wiped, pt[0]):
        assert torch.equal(g, w)
    out = ra.finalize(pt[1], torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def _shard_seq(x, n):
    """(B, H, L, D) -> (n, B, H, L/n, D): PE p holds rows [p*L/n, ...)."""
    b, h, length, d = x.shape
    return np.ascontiguousarray(
        x.reshape(b, h, n, length // n, d).transpose(2, 0, 1, 3, 4))


def _unshard_seq(x):
    n, b, h, ls, d = x.shape
    return x.transpose(1, 2, 0, 3, 4).reshape(b, h, n * ls, d)


RING_CASES = [(True, None, 4), (False, None, 4), (True, 10, 2),
              (True, None, 2), (True, 6, 4)]        # tests/test_fused.py


@pytest.mark.parametrize("noc", [False, True])
@pytest.mark.parametrize("causal,window,hkv", RING_CASES)
def test_ring_attention_matches_jax_and_mono(causal, window, hkv, noc):
    n, b, hq, length, d = 4, 2, 4, 32, 16
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, hq, length, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, length, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, length, d)).astype(np.float32)
    pos = np.arange(length, dtype=np.int32).reshape(n, length // n)
    sh = [_shard_seq(x, n) for x in (q, k, v)]
    jout = jfusion.ring_attention(
        jshmem.sim_ctx(n, jepiphany3(), noc=noc), *map(jnp.asarray, sh),
        jnp.asarray(pos), jnp.asarray(pos), causal=causal, window=window,
        use_pallas=False)
    ctx = sim_ctx(n, epiphany3(), noc=noc, device="cpu")
    out = fusion.ring_attention(ctx, *map(t, sh), t(pos), t(pos),
                                causal=causal, window=window)
    close(out, jout, rtol=0, atol=RING_ATOL)
    mono = ops.attention(t(q), t(k), t(v), causal=causal, window=window)
    close(torch.from_numpy(_unshard_seq(out.numpy())), mono.numpy(),
          rtol=0, atol=RING_ATOL)


def test_ring_attention_n1_is_mono():
    """tests/test_fused.py's case, at its head dim 8."""
    b, h, length, d = 1, 2, 16, 8
    q = np.random.default_rng(3).standard_normal(
        (b, h, length, d)).astype(np.float32)
    mono = ops.attention(t(q), t(q), t(q), causal=True)
    pos = t(np.arange(length, dtype=np.int32)[None])
    out = fusion.ring_attention(sim_ctx(1, device="cpu"), t(q)[None],
                                t(q)[None], t(q)[None], pos, pos,
                                causal=True)
    close(out[0], mono.numpy(), rtol=0, atol=RING_ATOL)


def test_ring_attention_padded_shards_with_softcap_match_jax():
    """A ragged sequence: 30 tokens over 4 PEs of 8 slots, the last PE's
    two spare slots at position -1 (never attended, their queries'
    outputs ignored), with GQA, a window and a softcap."""
    n, b, hq, hkv, d, per = 4, 1, 6, 2, 16, 8
    rng = np.random.default_rng(11)
    q = rng.standard_normal((n, b, hq, per, d)).astype(np.float32)
    k = rng.standard_normal((n, b, hkv, per, d)).astype(np.float32)
    v = rng.standard_normal((n, b, hkv, per, d)).astype(np.float32)
    pos = np.arange(n * per, dtype=np.int32).reshape(n, per)
    pos[-1, -2:] = -1
    kw = dict(causal=True, window=9, softcap=2.0)
    jout = jfusion.ring_attention(
        jshmem.sim_ctx(n), *map(jnp.asarray, (q, k, v, pos, pos)),
        use_pallas=False, **kw)
    out = fusion.ring_attention(sim_ctx(n, device="cpu"),
                                *map(t, (q, k, v, pos, pos)), **kw)
    real = pos >= 0
    np.testing.assert_allclose(
        out.numpy().transpose(0, 3, 1, 2, 4)[real],
        np.asarray(jout).transpose(0, 3, 1, 2, 4)[real], rtol=0,
        atol=RING_ATOL)


def test_ring_attention_schedule_launch_counts():
    """One partials call per ring step (n), and a put of k, v and k_pos
    for each of the n - 1 rotations."""
    n = 4
    a = [_shard_seq(x, n) for x in _block(5, 1, 2, 2, 16, 16, 16)[:3]]
    pos = t(np.arange(16, dtype=np.int32).reshape(n, 4))
    calls = {"partials": 0, "put": 0}
    real_p, real_c = ra.attn_block_partials, pc.put_copy

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    with mock.patch.object(ra, "attn_block_partials",
                           count("partials", real_p)), \
            mock.patch.object(pc, "put_copy", count("put", real_c)):
        fusion.ring_attention(sim_ctx(n, device="cpu"), *map(t, a), pos,
                              pos)
    assert calls == {"partials": n, "put": 3 * (n - 1)}


def test_ring_attention_of_a_model_layer_matches_the_jax_layer():
    """The slice as a whole at a small size: the smoke qwen2 layer's q, k,
    v (`layers.attention_qkv`) sequence-sharded over 4 PEs through ring
    attention, then `wo`, equal the JAX layer's attention output."""
    jcfg = jax_smoke("qwen2-0.5b", dtype=jnp.float32)
    cfg = smoke_config("qwen2-0.5b", dtype=torch.float32)
    jp = JL.init_attention(jax.random.key(0), jcfg, 1)
    jp = {name: jnp.asarray(np.random.RandomState(5).randn(*w.shape) * .1,
                            jnp.float32) if name.startswith("b") else w
          for name, w in jp.items()}
    tp_ = {name: t(w) for name, w in jp.items()}
    n, length = 4, 32
    x = np.random.RandomState(6).randn(1, length, cfg.d_model).astype(
        np.float32)
    positions = np.arange(length, dtype=np.int32)[None]
    want = JL.attention(JComm(JAxisSpec(model=None), "xla"), jcfg, jp,
                        jnp.asarray(x), jnp.asarray(positions))
    q, k, v = L.attention_qkv(cfg, tp_, t(x), t(positions).long())
    sh = [t(_shard_seq(z.numpy(), n)) for z in (q, k, v)]
    pos = t(positions.reshape(n, length // n))
    out = fusion.ring_attention(sim_ctx(n, device="cpu"), *sh, pos, pos,
                                causal=True)
    o = torch.from_numpy(_unshard_seq(out.numpy())).transpose(1, 2)
    got = L._dense(o.reshape(1, length, -1), tp_["wo"])
    close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("kv_bytes,compute_s", [
    (1 << 10, 1e-7), (1 << 20, 1e-4), (1 << 20, 1.0), (3 << 22, 2e-3)])
@pytest.mark.parametrize("board", [False, True])
def test_choose_attention_matches_jax(n, kv_bytes, compute_s, board):
    """Pick and modeled times exactly, on the default link and on the
    paper's board (4x4 eMesh, its NoC link)."""
    from repro.core import abmodel as jab
    from repro_torch.core import abmodel
    kw = dict(topo=epiphany3(), link=abmodel.EPIPHANY_NOC) if board else {}
    jkw = dict(topo=jepiphany3(), link=jab.EPIPHANY_NOC) if board else {}
    got = fusion.choose_attention(n, kv_bytes, compute_s, **kw)
    want = jfusion.choose_attention(n, kv_bytes, compute_s, **jkw)
    assert got == want


def test_choose_attention_overlap_wins_when_compute_hides_comm():
    name, times = fusion.choose_attention(8, 1 << 20, 1.0)
    assert name == "ring" and times["ring"] < times["mono"]
    assert fusion.choose_attention(1, 1 << 20, 1.0)[0] == "mono"


def test_choose_attention_tuner_raises():
    with pytest.raises(NotImplementedError):
        fusion.choose_attention(8, 1 << 20, 1.0, tuner=object())


def test_ring_attention_on_another_net_raises():
    ctx = types.SimpleNamespace(net=NetOps())
    z = torch.zeros(2, 1, 1, 4, 16)
    pos = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="SPMD"):
        fusion.ring_attention(ctx, z, z, z, pos, pos)


def test_partials_on_another_device_raise():
    a = [x.to("meta") for x in map(t, _block(0, 1, 2, 2, 8, 8, 16))]
    with pytest.raises(ValueError, match="no kernel"):
        ra.attn_block_partials(*a)


@pytest.mark.parametrize("change,exc", [
    (dict(vlen=4), ValueError), (dict(klen=0), ValueError),
    (dict(d=0), ValueError), (dict(d=257), ValueError),
    (dict(hkv=4), ValueError),
    (dict(dtype=torch.float16), TypeError), (dict(kdtype=True), TypeError),
    (dict(pos64=True), TypeError), (dict(window=0), ValueError),
    (dict(softcap=-1.0), ValueError), (dict(qpos_len=5), ValueError)])
def test_partials_reject_what_the_kernel_does_not_take(change, exc):
    d = change.get("d", 16)
    q, k, v, qp, kp = map(t, _block(0, 1, 6, change.get("hkv", 2), 8, 8, d))
    if "dtype" in change:
        q, k, v = (z.to(change["dtype"]) for z in (q, k, v))
    if change.get("kdtype"):
        k = k.to(torch.bfloat16)
    if change.get("pos64"):
        qp = qp.long()
    if "qpos_len" in change:
        qp = qp[:change["qpos_len"]]
    if "vlen" in change:
        v = v[..., :change["vlen"], :]
    if "klen" in change:
        k, v = (z[..., :change["klen"], :] for z in (k, v))
        kp = kp[:change["klen"]]
    kw = {name: change[name] for name in ("window", "softcap")
          if name in change}
    with pytest.raises(exc):
        ra.attn_block_partials(q, k, v, qp, kp, **kw)


# fault C1: the zoo's head dims (gemma2-9b 256, h2o-danube-3-4b 120,
# phi-3-vision-4.2b 96, hubert-xlarge 80, deepseek-v3's MLA q/k 192 and
# its smoke 24), on a diagonal block and on a padded, windowed, capped one
C1_DIMS = [80, 96, 120, 256, 24, 192]
C1_BLOCKS = [BLOCKS[0], BLOCKS[-1]]


@pytest.mark.parametrize("case", C1_BLOCKS, ids=[c[0] for c in C1_BLOCKS])
@pytest.mark.parametrize("d", C1_DIMS)
def test_partials_at_any_head_dim_match_jax(d, case):
    _, hq, hkv, lq, lk, _, q0, k0, pad, kw = case
    a = _block(17, 1, hq, hkv, lq, lk, d, q0, k0, pad)
    want = _jax_partials(*a, **kw)
    got = ra.attn_block_partials(*map(t, a), **kw)
    assert got[0].shape == (1, hq, lq, d)
    for g, w in zip(got, want):
        close(g, w)


# ---------------------------------------------------------------------------
# kernel 6's tile skipping, replayed tile by tile in plain torch
# ---------------------------------------------------------------------------

def _replay_partials(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                     softcap=None, bq=64, bk=ra.BK):
    """Kernel 6's schedule in plain f32 torch (no P axis): for each query
    tile of `bq` rows, walk the `bk`-slot key tiles in order, skipping each
    whose valid key positions all lie after the tile's latest query
    position (causal) or at or before its earliest one's window; the online
    softmax over the tiles walked; a row that kept nothing written as (the
    sum of v over the Lk slots, -1e30, Lk).  Returns (acc, m, l, skipped
    tiles, rows that kept nothing)."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = k.float().repeat_interleave(group, 1)
    vv = v.float().repeat_interleave(group, 1)
    scale = 1.0 / np.sqrt(d)
    acc = torch.zeros(b, hq, lq, d)
    m = torch.full((b, hq, lq), NEG_INF)
    l = torch.zeros(b, hq, lq)
    skipped = dead_rows = 0
    for q0 in range(0, lq, bq):
        rows = slice(q0, min(q0 + bq, lq))
        qp = q_pos[rows]
        qmin, qmax = int(qp.min()), int(qp.max())
        n = qp.shape[0]
        a_, m_ = torch.zeros(b, hq, n, d), torch.full((b, hq, n), NEG_INF)
        l_, kept = torch.zeros(b, hq, n), torch.zeros(n, dtype=torch.bool)
        for k0 in range(0, lk, bk):
            kp = k_pos[k0:k0 + bk]
            valid = kp[kp >= 0]
            if (len(valid) == 0 or (causal and int(valid.min()) > qmax)
                    or (window and int(valid.max()) <= qmin - window)):
                skipped += 1
                continue
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows].float(),
                             kk[:, :, k0:k0 + bk]) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            ok = (kp >= 0)[None, :].expand(n, -1)
            if causal:
                ok = ok & (kp[None, :] <= qp[:, None])
            if window:
                ok = ok & (kp[None, :] > qp[:, None] - window)
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m_, s.amax(-1))
            p_ = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_ - m_new)
            l_ = alpha * l_ + p_.sum(-1)
            a_ = a_ * alpha[..., None] + p_ @ vv[:, :, k0:k0 + bk]
            m_ = m_new
            kept |= ok.any(-1)
        a_[:, :, ~kept] = vv.sum(2)[:, :, None, :]
        m_[:, :, ~kept] = NEG_INF
        l_[:, :, ~kept] = float(lk)
        dead_rows += int((~kept).sum())
        acc[:, :, rows], m[:, :, rows], l[:, :, rows] = a_, m_, l_
    return acc, m, l, skipped, dead_rows


def _positions(layout, lq, lk, rng):
    """(q_pos, k_pos) int32 for the replay: "late" keys in falling order,
    so a query row keeps its first key only after masked tiles; "none"
    keys from the middle of the queries on, so the early rows keep
    nothing; "pad" a shard of unequal length with padded query and key
    slots (-1), some key tiles wholly padded; "shuffled" key positions in
    random order, every tile spanning a wide range."""
    q_pos = np.arange(100, 100 + lq, dtype=np.int32)
    if layout == "late":
        k_pos = np.arange(lk + 60, 60, -1, dtype=np.int32)
    elif layout == "none":
        k_pos = np.arange(100 + lq // 2, 100 + lq // 2 + lk, dtype=np.int32)
    elif layout == "pad":
        k_pos = np.arange(40, 40 + lk, dtype=np.int32)
        k_pos[rng.random(lk) < 0.3] = -1
        k_pos[64:128] = -1
        q_pos[-5:] = -1
    else:
        k_pos = rng.permutation(np.arange(30, 30 + lk, dtype=np.int32))
    return q_pos, k_pos


REPLAY = [("late", dict(causal=True)), ("late", dict(causal=True, window=40)),
          ("none", dict(causal=True)), ("none", dict(causal=True, window=9)),
          ("pad", dict(causal=True, window=50, softcap=5.0)),
          ("pad", dict(causal=False, window=30)),
          ("shuffled", dict(causal=True, window=70)),
          ("shuffled", dict(causal=False))]


@pytest.mark.parametrize("bq", [64, 32])
@pytest.mark.parametrize("layout,kw", REPLAY,
                         ids=[f"{lay}-" + "-".join(f"{k}{v}" for k, v in
                                                   kw.items())
                              for lay, kw in REPLAY])
def test_tile_skipping_replay_matches_jax(layout, kw, bq):
    """The replay of kernel 6's skipping (the tensor-core route's 64-row
    and the CUDA-core route's 32-row query tiles) equals the reference's
    partials, which compute every pair, on tables where rows keep nothing,
    keep their first key late, or sit in padded shards with windows."""
    rng = np.random.default_rng(18)
    lq, lk = 150, 300
    q, k, v, _, _ = _block(19, 1, 4, 2, lq, lk, 16)
    q_pos, k_pos = _positions(layout, lq, lk, rng)
    acc, m, l, skipped, dead = _replay_partials(
        *map(t, (q, k, v, q_pos, k_pos)), bq=bq, **kw)
    want = _jax_partials(q, k, v, q_pos, k_pos, **kw)
    for g, w in zip((acc, m, l), want):
        close(g, w)
    # the tables exercise the rule: tiles are skipped, and rows keep
    # nothing (the early rows of "none"; the padded queries under causal)
    assert skipped or layout == "shuffled"
    assert dead or not (layout == "none" or layout == "pad"
                        and kw["causal"])
    dead_ref = np.asarray(want[1]) == NEG_INF
    assert np.array_equal(m.numpy() == NEG_INF, dead_ref)


def test_bf16_partials_follow_the_reference_on_bf16_inputs():
    """bf16 q, k, v are upcast before the product, as the reference does."""
    a = _block(9, 1, 4, 2, 16, 40, 16, q0=20, k0=0, pad=2)
    bf = [t(x).to(torch.bfloat16) for x in a[:3]]
    got = ra.attn_block_partials(*bf, t(a[3]), t(a[4]), causal=True)
    jbf = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in bf]
    want = jra.attn_block_partials(*jbf, jnp.asarray(a[3]),
                                   jnp.asarray(a[4]), causal=True,
                                   use_pallas=False)
    for g, w in zip(got, want):
        close(g, w)
    assert all(g.dtype == torch.float32 for g in got)

