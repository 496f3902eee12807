"""The paged decode-attention op (`repro_torch.kernels.paged_decode`).

On the CPU its plain version must be, bit for bit, the decode path it
replaced in `layers.attention_paged`: every row's pages gathered out to
max_pages x page_size, the mask of positions [pos - window + 1, pos], and
`_attend_mq`'s f32 arithmetic (`_former_attend_mq` below is that function
as it stood).  The tests marked `cuda` hold the kernel to the plain
version on a card and skip without one; `chip_smoke.py` runs the same
cases on the card and times the kernel."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import paged_decode as kpd
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import layers as L
from repro_torch.parallel.comm import Comm


def _former_attend_mq(q, ck, cv, valid, softcap, q2slot):
    """`layers._attend_mq` as the decode called it before the kernel."""
    if q2slot is not None:
        ck, cv = ck.index_select(2, q2slot), cv.index_select(2, q2slot)
    B, S, K = ck.shape[0], ck.shape[1], ck.shape[2]
    L_, hq, hd = q.shape[1], q.shape[2], q.shape[3]
    group = hq // K
    qf = q.float() / math.sqrt(hd)
    kf, vf = ck.float(), cv.float()
    qg = qf.reshape(B, L_, K, group, hd)
    logits = torch.einsum("blkgd,bskd->blkgs", qg, kf).reshape(B, L_, hq, S)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(valid[:, :, None, :], logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p_ = torch.exp(logits - m)
    l_den = p_.sum(-1, keepdim=True)
    pg = p_.reshape(B, L_, K, group, S)
    acc = torch.einsum("blkgs,bskd->blkgd", pg, vf).reshape(B, L_, hq, hd)
    return acc / l_den.clamp_min(1e-30)


def _former_decode(q, pool_k, pool_v, table, positions, window, softcap,
                   q2slot):
    """The former decode branch: q (B, Hq, hd), positions (B,)."""
    ck = L.paged_kv_gather(pool_k, table)
    cv = L.paged_kv_gather(pool_v, table)
    pos = positions[:, None]
    kv_pos = torch.arange(ck.shape[1])[None, None, :]
    valid = kv_pos <= pos[:, :, None]
    if window is not None:
        valid &= kv_pos > (pos[:, :, None] - window)
    return _former_attend_mq(q[:, None], ck, cv, valid, softcap, q2slot)[:, 0]


MAX_PAGES = 8


def _rows(page_size):
    """Positions of the edge rows: 0, a page's first and last row, the
    last position of max_seq, and two inside."""
    last = MAX_PAGES * page_size - 1
    return [0, 2 * page_size, 3 * page_size - 1, last, 5, last - 9]


def _case(group, hd, page_size, variant, dtype=torch.float32, rows=None,
          max_pages=MAX_PAGES, seed=0, device="cpu"):
    """Inputs of one case: rows at `_rows`' positions (or `rows`), each
    with its own pages of a shuffled pool, and one more row on the null
    page only (page table all 0, position 0).  Two kv heads of `group` q
    heads each; under `q2slot`, group + 1 q heads reading three stored
    heads in a random map."""
    rng = np.random.default_rng(seed)
    positions = list(_rows(page_size) if rows is None else rows)
    b = len(positions) + 1
    q2slot = variant.get("q2slot")
    hkv = 3 if q2slot else 2
    hq = group + 1 if q2slot else group * hkv
    num_pages = 1 + (b - 1) * max_pages

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    pool_k = normal(num_pages, page_size, hkv, hd).to(dtype)
    pool_v = normal(num_pages, page_size, hkv, hd).to(dtype)
    table = torch.zeros((b, max_pages), dtype=torch.long)
    perm = torch.from_numpy(rng.permutation(np.arange(1, num_pages)))
    for r, pos in enumerate(positions):
        n = pos // page_size + 1
        table[r, :n] = perm[r * max_pages:r * max_pages + n]
    q = (2.0 * normal(b, hq, hd)).to(dtype)
    slots = torch.from_numpy(rng.integers(0, hkv, hq)) if q2slot else None
    pos_t = torch.tensor(positions + [0], dtype=torch.long)
    put = lambda t: None if t is None else t.to(device)  # noqa: E731
    return dict(q=put(q), pool_k=put(pool_k), pool_v=put(pool_v),
                table=put(table), positions=put(pos_t), page_size=page_size,
                window=variant.get("window"), softcap=variant.get("softcap"),
                q2slot=put(slots))


def _op(c):
    return kpd.paged_decode_attention(
        c["q"], c["pool_k"], c["pool_v"], c["table"], c["positions"],
        page_size=c["page_size"], window=c["window"], softcap=c["softcap"],
        q2slot=c["q2slot"])


VARIANTS = {"plain": {}, "softcap": {"softcap": 50.0},
            "window": {"window": 13}, "q2slot": {"q2slot": True},
            "all": {"softcap": 50.0, "window": 13, "q2slot": True}}


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("group", [1, 6, 7])
def test_plain_version_is_the_former_decode_bitwise(group, hd, variant,
                                                    page_size):
    c = _case(group, hd, page_size, VARIANTS[variant])
    got = _op(c)
    want = _former_decode(c["q"], c["pool_k"], c["pool_v"], c["table"],
                          c["positions"], c["window"], c["softcap"],
                          c["q2slot"])
    assert got.dtype == torch.float32 and got.shape == c["q"].shape
    assert torch.equal(got, want)


def test_window_and_softcap_change_the_result():
    """The cases above would not tell a dropped window or softcap."""
    base = _op(_case(6, 64, 8, {}))
    for variant in ({"window": 13}, {"softcap": 50.0}):
        assert not torch.equal(_op(_case(6, 64, 8, variant)), base)


@pytest.mark.parametrize("variant", [dict(), dict(window=5),
                                     dict(softcap=20.0)])
def test_attention_paged_decode_is_unchanged(variant, monkeypatch):
    """`attention_paged` at L == 1 on the CPU gives, bit for bit, what the
    former decode branch gave on the same pool (the op patched back to
    the former gather and `_attend_mq`)."""
    cfg = dataclasses.replace(smoke_config("qwen2-0.5b", dtype=torch.float32,
                                           n_heads=6, n_kv_heads=2),
                              **variant)
    gen = torch.Generator().manual_seed(0)
    p = L.init_attention(gen, cfg, 1, "cpu")
    rng = np.random.default_rng(1)
    pool = torch.from_numpy(rng.standard_normal(
        (9, 4, cfg.n_kv_heads, cfg.hd), dtype=np.float32))
    table = torch.tensor([[3, 5, 1, 0], [2, 7, 8, 0], [0, 0, 0, 0]])
    x = torch.from_numpy(rng.standard_normal((3, 1, cfg.d_model),
                                             dtype=np.float32))
    positions = torch.tensor([[9], [11], [0]])

    def run():
        pools = {"k": pool.clone(), "v": pool.clone() + 1}
        y, _ = L.attention_paged(Comm(), cfg, p, x, pools, table, positions,
                                 page_size=4)
        return y, pools

    y, pools = run()
    calls = []

    def former(q, pool_k, pool_v, table_, pos, *, page_size, window,
               softcap, q2slot, rows=None):
        calls.append(window)
        return _former_decode(q, pool_k, pool_v, table_, pos, window,
                              softcap, q2slot)

    monkeypatch.setattr(kpd, "paged_decode_attention", former)
    y_former, pools_former = run()
    assert calls == [cfg.window]
    assert torch.equal(y, y_former)
    for name in ("k", "v"):
        assert torch.equal(pools[name], pools_former[name])


@pytest.mark.parametrize("bad", ["dtype", "hd_not_8", "hd_over_256",
                                 "strided_pool"])
def test_wrapper_refuses(bad):
    c = _case(2, 64, 8, {})
    if bad == "dtype":
        c["pool_k"], c["pool_v"] = c["pool_k"].half(), c["pool_v"].half()
        err = TypeError
    elif bad == "hd_not_8":
        c["q"] = c["q"][..., :60]
        c["pool_k"] = c["pool_k"][..., :60].contiguous()
        c["pool_v"] = c["pool_v"][..., :60].contiguous()
        err = ValueError
    elif bad == "hd_over_256":
        c["q"] = torch.cat([c["q"]] * 5, -1)[..., :264]
        c["pool_k"] = torch.cat([c["pool_k"]] * 5, -1)[..., :264]
        c["pool_v"] = torch.cat([c["pool_v"]] * 5, -1)[..., :264]
        err = ValueError
    else:
        c["pool_k"] = c["pool_k"].transpose(1, 2).contiguous() \
            .transpose(1, 2)
        err = ValueError
    before = kpd.launches
    with pytest.raises(err):
        _op(c)
    assert kpd.launches == before


def _close(got, want):
    """The kernel sums in another order than the plain version (per split,
    then the splits combined; the plain version's einsums over all
    max_seq positions): within 1e-4 of the largest |value| plus 1e-5."""
    err = (got - want).abs().max().item()
    lim = 1e-4 * want.abs().max().item() + 1e-5
    assert err <= lim, (err, lim)


def _layers_with_rows(c):
    """Three layers' pools through one step's `decode_rows` and each
    through a call of its own."""
    rows = kpd.decode_rows(c["table"], c["positions"],
                           page_size=c["page_size"])
    kw = {k: c[k] for k in ("page_size", "window", "softcap", "q2slot")}
    got = []
    for layer in range(3):
        pk, pv = c["pool_k"] + layer, c["pool_v"] - layer
        got.append((kpd.paged_decode_attention(c["q"], pk, pv, c["table"],
                                               c["positions"], rows=rows,
                                               **kw),
                    kpd.paged_decode_attention(c["q"], pk, pv, c["table"],
                                               c["positions"], **kw)))
    return got


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_rows_shared_by_the_layers_of_a_step(variant):
    """One `decode_rows` for several layers' pools gives each layer what
    its own call gives.  On the CPU both are the plain version, and two
    calls of it need not agree to the bit: the first f32 products and
    sums of a fresh process have been seen to round otherwise than the
    next call's (once in ~20 runs of this file, ~2.5e-5 of the largest
    value), so within `_close`'s bound.  On the card the bits agree (the
    test below)."""
    for shared, alone in _layers_with_rows(_case(6, 64, 8,
                                                 VARIANTS[variant])):
        _close(shared, alone)


@pytest.mark.parametrize("bad", ["dtype", "strided_pool", "page_size"])
def test_rows_check_a_later_layer_that_differs(bad):
    """The shapes checked at a step's first layer are checked again where
    a later layer brings others, and a strided pool is refused at every
    layer."""
    c = _case(2, 64, 8, {})
    rows = kpd.decode_rows(c["table"], c["positions"], page_size=8)
    _op(dict(c))
    kpd.paged_decode_attention(c["q"], c["pool_k"], c["pool_v"], c["table"],
                               c["positions"], page_size=8, rows=rows)
    pk, pv, ps, err = c["pool_k"], c["pool_v"], 8, ValueError
    if bad == "dtype":
        pk, pv, err = pk.half(), pv.half(), TypeError
    elif bad == "strided_pool":
        pk = pk.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        ps = 4
    with pytest.raises(err):
        kpd.paged_decode_attention(c["q"], pk, pv, c["table"],
                                   c["positions"], page_size=ps, rows=rows)


def test_rows_refuse_mismatched_table_and_positions():
    c = _case(2, 64, 8, {})
    with pytest.raises(ValueError):
        kpd.decode_rows(c["table"], c["positions"][:-1], page_size=8)
    with pytest.raises(ValueError):
        kpd.decode_rows(c["table"][0], c["positions"], page_size=8)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU path")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("shape", [(6, 128, 8), (1, 96, 8), (7, 64, 16),
                                   (2, 256, 16), (4, 120, 8)])
def test_kernel_matches_the_plain_version(cuda, shape, variant, dtype):
    """internlm2-20b's (group 6, hd 128) and phi-3-vision's (MHA, hd 96)
    decode heads, qwen2-0.5b's (7, 64), gemma2's (2, 256) and danube's
    (4, 120), over the edge rows, pages of 8 and 16."""
    group, hd, ps = shape
    c = _case(group, hd, ps, VARIANTS[variant], dtype, device=cuda)
    before = kpd.launches
    got = _op(c)
    assert kpd.launches == before + 1
    want = kpd.ref.paged_decode_ref(
        c["q"], c["pool_k"], c["pool_v"], c["table"], c["positions"],
        page_size=ps, window=c["window"], softcap=c["softcap"],
        q2slot=c["q2slot"])
    torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.cuda
def test_kernel_long_rows_many_splits(cuda):
    """Rows of thousands of positions: many splits combined."""
    rows = [4095, 2048, 1000, 257, 255, 256]
    c = _case(6, 128, 8, {}, torch.bfloat16, rows=rows, max_pages=512,
              device=cuda)
    got = _op(c)
    want = kpd.ref.paged_decode_ref(
        c["q"], c["pool_k"], c["pool_v"], c["table"], c["positions"],
        page_size=8)
    _close(got, want)


@pytest.mark.cuda
def test_kernel_row_alone_equals_row_in_a_batch_of_64(cuda):
    rng = np.random.default_rng(5)
    rows = [int(x) for x in rng.integers(0, MAX_PAGES * 8, 63)]
    c = _case(6, 128, 8, {}, torch.bfloat16, rows=rows, device=cuda)
    batched = _op(c)
    first = _op(c)
    assert torch.equal(batched, first)                  # run to run
    for r in (0, 17, 62, 63):
        alone = kpd.paged_decode_attention(
            c["q"][r:r + 1], c["pool_k"], c["pool_v"], c["table"][r:r + 1],
            c["positions"][r:r + 1], page_size=8)
        assert torch.equal(alone[0], batched[r])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_kernel_rows_shared_by_the_layers_of_a_step(cuda, variant):
    """On the card the step's `decode_rows` give each layer's launch the
    bits of a launch of its own."""
    c = _case(6, 128, 8, VARIANTS[variant], torch.bfloat16, device=cuda)
    for shared, alone in _layers_with_rows(c):
        assert torch.equal(shared, alone)
