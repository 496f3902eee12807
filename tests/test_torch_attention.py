"""The port's attention op against the JAX package's reference.

On the CPU `repro_torch.kernels.ops.attention` runs its padding and the
`lk_valid` edge around the plain version, so these tests hold the op's
whole CPU path to `repro.kernels.ref.attention_ref` on the same numpy
inputs.  (The JAX side uses its plain reference: Pallas interpret mode
does not run under every jax release.)  The CUDA kernel itself is held to
the plain version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

ATTN_CASES = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=17),
    dict(causal=True, softcap=30.0),
    dict(causal=True, window=33, softcap=50.0),
]
# causal assumes aligned positions: only lq == lk for the causal cases
GRID = [(kw, lq, lk, group) for kw in ATTN_CASES
        for lq, lk, group in [(64, 64, 2), (100, 100, 1), (32, 96, 4)]
        if not (kw.get("causal") and lq != lk)]
F32_TOL = 3e-5       # as tests/test_kernels.py for the f32 kernel
BF16_TOL = 3e-2      # as tests/test_kernels.py for the bf16 kernel
# q and k at 2.5x unit scale give logits of std ~6: the softmax is peaked
# (the top key takes ~0.7 of a row on average), the softcaps of ATTN_CASES
# move the output by several bf16 tolerances, and |out| is ~0.65 on
# average, some 20x the bf16 tolerance
QK_SCALE = 2.5


def _inputs(seed, b, hq, hkv, lq, lk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, lq, d).astype(np.float32) * QK_SCALE,
            rng.randn(b, hkv, lk, d).astype(np.float32) * QK_SCALE,
            rng.randn(b, hkv, lk, d).astype(np.float32))


def _both(arrays, dtype):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a).astype(jdt) for a in arrays])


def _case_id(case):
    kw, lq, lk, group = case
    return "-".join([f"{k}{v}" for k, v in kw.items()]
                    + [f"lq{lq}", f"lk{lk}", f"g{group}"])


@pytest.mark.parametrize("kw,lq,lk,group", GRID,
                         ids=[_case_id(c) for c in GRID])
def test_attention_matches_jax_ref_f32(kw, lq, lk, group):
    arrays = _inputs(0, 2, 2 * group, 2, lq, lk, 32)
    (q, k, v), (jq, jk, jv) = _both(arrays, "float32")
    out = ops.attention(q, k, v, **kw)
    want = jref.attention_ref(jq, jk, jv, **kw)
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=F32_TOL)


SOFTCAP_GRID = [c for c in GRID if "softcap" in c[0]]


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("kw,lq,lk,group", SOFTCAP_GRID,
                         ids=[_case_id(c) for c in SOFTCAP_GRID])
def test_softcap_cases_can_tell_a_kernel_that_ignores_softcap(
        kw, lq, lk, group, dtype, tol):
    """At these inputs dropping the softcap moves the output by more than
    twice the tolerance, so a case with softcap fails a kernel that
    ignores it."""
    (q, k, v), _ = _both(_inputs(0, 2, 2 * group, 2, lq, lk, 32), dtype)
    want = ops.attention(q, k, v, **kw).float()
    blind = ops.attention(q, k, v, **{**kw, "softcap": None}).float()
    assert (want - blind).abs().max().item() > 2 * tol
    assert want.abs().mean().item() > 10 * tol


def test_attention_matches_jax_ref_bf16():
    (q, k, v), (jq, jk, jv) = _both(_inputs(1, 1, 2, 2, 64, 64, 32),
                                    "bfloat16")
    out = ops.attention(q, k, v)
    want = jref.attention_ref(jq, jk, jv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=BF16_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("lq,lk", [(128, 256), (100, 256)])
def test_attention_qwen2_prefill_shape(dtype, tol, lq, lk):
    """The serving prefill's shape: Hq 14 over Hkv 2 (a group of 7),
    head dim 64, the prompt bucket against S_max = max_pages * page."""
    (q, k, v), (jq, jk, jv) = _both(_inputs(2, 1, 14, 2, lq, lk, 64), dtype)
    out = ops.attention(q, k, v, causal=True, sm_scale=0.125)
    want = jref.attention_ref(jq, jk, jv, causal=True, sm_scale=0.125)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


def test_fully_masked_rows_stay_finite():
    """Keys past lk_valid are masked at -1e30, never -inf, so a row with
    no valid key averages the values instead of producing NaN."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 2, 64, 64, 16))
    out = fa.flash_attention(q, k, v, causal=False, lk_valid=0)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, v.mean(2, keepdim=True).expand_as(out))


def test_cpu_path_does_not_count_launches():
    before = fa.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 2, 2, 64, 64, 16))
    fa.flash_attention(q, k, v)
    assert fa.launches == before


def _dims(q, k, v, d, dv):
    """q, k, v of the same lengths with head dims d (q, k) and dv (v)."""
    return (q.new_zeros(q.shape[:3] + (d,)), k.new_zeros(k.shape[:3] + (d,)),
            v.new_zeros(v.shape[:3] + (dv,)))


@pytest.mark.parametrize("change,exc", [
    (lambda q, k, v: (q.half(), k.half(), v.half()), TypeError),
    (lambda q, k, v: (q[:, :, :32], k, v), ValueError),          # Lq % 64
    (lambda q, k, v: (q, k[:, :, :40], v[:, :, :40]), ValueError),  # Lk % 64
    (lambda q, k, v: (q.transpose(2, 3).contiguous().transpose(2, 3), k, v),
     ValueError),                                                # strides
    (lambda q, k, v: _dims(q, k, v, 0, 16), ValueError),         # D 0
    (lambda q, k, v: _dims(q, k, v, 257, 16), ValueError),       # D 257
    (lambda q, k, v: _dims(q, k, v, 16, 257), ValueError),       # Dv 257
    (lambda q, k, v: (q, k, v[:, :, :32].contiguous()), ValueError),  # k/v Lk
    (lambda q, k, v: (q[:, :1], k, v), ValueError),              # Hq % Hkv
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, exc):
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 2, 2, 64, 64, 16))
    with pytest.raises(exc):
        fa.flash_attention(*change(q, k, v))


@pytest.mark.parametrize("bq,bk", [(16, 64), (32, 96), (0, 64)])
def test_ops_rejects_padding_off_the_kernel_tiles(bq, bk):
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, 1, 2, 2, 32, 64, 16))
    with pytest.raises(ValueError):
        ops.attention(q, k, v, bq=bq, bk=bk)


def test_ops_pads_to_multiples_of_the_kernel_tiles():
    q, k, v = (torch.from_numpy(a) for a in _inputs(8, 1, 2, 2, 40, 70, 16))
    torch.testing.assert_close(ops.attention(q, k, v, bq=64, bk=128),
                               ops.attention(q, k, v))


@pytest.mark.parametrize("kw", [dict(window=0), dict(softcap=0.0),
                                dict(lk_valid=65)])
def test_wrapper_rejects_bad_options(kw):
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 2, 2, 64, 64, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, **kw)


# ---------------------------------------------------------------------------
# fault C1: any head dim in 1..256, and a head dim of v of its own
# ---------------------------------------------------------------------------

# the zoo's full-width head dims (gemma2-9b 256, h2o-danube-3-4b 120,
# phi-3-vision-4.2b 96, hubert-xlarge 80) and deepseek-v3's MLA, whose v
# head dim is its own (192 / 128; 24 / 16 in its smoke config)
HEAD_DIMS = [(80, 80), (96, 96), (120, 120), (256, 256), (24, 16), (192, 128)]
HEAD_DIM_MASKS = [dict(causal=True), dict(causal=False),
                  dict(causal=True, window=9),
                  dict(causal=True, window=13, softcap=50.0)]
C1_TOL = dict(rtol=1e-4, atol=1e-5)


def _c1_inputs(seed, hq, hkv, lq, lk, d, dv):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, hq, lq, d).astype(np.float32),
            rng.randn(1, hkv, lk, d).astype(np.float32),
            rng.randn(1, hkv, lk, dv).astype(np.float32))


@pytest.mark.parametrize("kw", HEAD_DIM_MASKS,
                         ids=["-".join(f"{k}{v}" for k, v in kw.items())
                              for kw in HEAD_DIM_MASKS])
@pytest.mark.parametrize("d,dv", HEAD_DIMS,
                         ids=[f"d{d}-dv{dv}" for d, dv in HEAD_DIMS])
def test_any_head_dim_matches_jax_ref_f32(d, dv, kw):
    """ops.attention (the padding around the wrapper's CPU path) against
    the reference at every head dim the zoo runs, a GQA group of 2, a
    ragged 40-token prompt: output (B, Hq, Lq, Dv)."""
    (q, k, v), (jq, jk, jv) = _both(_c1_inputs(12, 4, 2, 40, 40, d, dv),
                                    "float32")
    out = ops.attention(q, k, v, **kw)
    want = jref.attention_ref(jq, jk, jv, **kw)
    assert out.shape == (1, 4, 40, dv)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **C1_TOL)


@pytest.mark.parametrize("d,dv", [(24, 16), (192, 128), (256, 256)])
def test_wrapper_takes_any_head_dim_with_lk_valid(d, dv):
    """The wrapper itself (Lq, Lk at the tile multiple, keys past lk_valid
    masked) against the reference on the valid keys alone."""
    (q, k, v), (jq, jk, jv) = _both(_c1_inputs(13, 2, 1, 64, 128, d, dv),
                                    "float32")
    out = fa.flash_attention(q, k, v, causal=False, lk_valid=100)
    want = jref.attention_ref(jq, jk[:, :, :100], jv[:, :, :100],
                              causal=False)
    assert out.shape == (1, 2, 64, dv)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **C1_TOL)


def test_grads_with_a_head_dim_of_v_of_its_own():
    """dq, dk, dv at MLA's smoke dims (q/k 24, v 16) against jax.vjp."""
    import jax
    arrays = _c1_inputs(14, 2, 2, 24, 24, 24, 16)
    cot = np.random.RandomState(15).randn(1, 2, 24, 16).astype(np.float32)
    (q, k, v), (jq, jk, jv) = _both(arrays, "float32")
    for x in (q, k, v):
        x.requires_grad_()
    ops.attention(q, k, v, window=7).backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, window=7),
                     jq, jk, jv)
    for x, want in zip((q, k, v), vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)


def test_plain_version_keeps_f64_inputs_in_f64():
    """f64 inputs run the plain version's steps in f64 (the oracle that
    holds the f32 kernel on the card): equal to the same softmax written
    out in f64, and to the reference."""
    arrays = _c1_inputs(16, 4, 2, 40, 40, 256, 128)
    q, k, v = (torch.from_numpy(a).double() for a in arrays)
    kw = dict(window=9, softcap=50.0)
    got = tref.attention_ref(q, k, v, **kw)
    assert got.dtype == torch.float64
    kk, vv = (x.repeat_interleave(2, dim=1) for x in (k, v))
    s = 50.0 * torch.tanh(q @ kk.transpose(2, 3) / 16.0 / 50.0)
    pos = torch.arange(40)
    keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - 9)
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    np.testing.assert_allclose(got.numpy(),
                               (torch.softmax(s, -1) @ vv).numpy(),
                               rtol=1e-12, atol=1e-13)
    want = jref.attention_ref(*map(jnp.asarray, arrays), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **C1_TOL)


# ---------------------------------------------------------------------------
# kernel 4's tile range: every key tile it skips is masked for every row
# ---------------------------------------------------------------------------

def _kernel4_tiles(q0, rows, lk, lk_valid, causal, window, bk=fa.BK):
    """(visited, whole) key tiles of the query rows q0 .. q0 + rows - 1, as
    csrc/attn_tile.cuh's range_visit computes them."""
    q1 = q0 + rows - 1
    hi = min(lk_valid - 1, q1) if causal else lk_valid - 1
    lo = max(0, q0 - window + 1) if window else 0
    visited = set(range(lo // bk, hi // bk + 1)) if hi >= lo else set()
    full_hi = lk_valid // bk - 1
    if causal:
        full_hi = min(full_hi, (q0 + 1) // bk - 1)
    full_lo = max(0, -(-(q1 + 1 - window) // bk)) if window else 0
    whole = set(range(full_lo, full_hi + 1)) & set(range(lk // bk))
    return visited & set(range(lk // bk)), whole


def _dense_mask(lq, lk, lk_valid, causal, window):
    q_pos = torch.arange(lq)[:, None]
    k_pos = torch.arange(lk)[None, :]
    mask = (k_pos < lk_valid).expand(lq, lk)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return mask


@pytest.mark.parametrize("rows", [64, 32])
@pytest.mark.parametrize("causal,window,lk_valid", [
    (True, None, 512), (False, None, 512), (True, 100, 512),
    (True, 1, 512), (False, 70, 512), (True, 64, 300), (False, None, 0),
    (True, 300, 130), (False, 5, 10)])
def test_kernel4_skips_only_wholly_masked_tiles(rows, causal, window,
                                                lk_valid):
    """Against a brute-force mask over a 512 x 512 grid: a tile the kernel
    skips is masked for every row of the query tile, a tile it visits has
    a kept pair (the range is tight), and a tile it takes as whole (no
    mask applied) is kept for every row."""
    lq = lk = 512
    mask = _dense_mask(lq, lk, lk_valid, causal, window)
    bk = fa.BK
    for q0 in range(0, lq, rows):
        visited, whole = _kernel4_tiles(q0, rows, lk, lk_valid, causal,
                                        window)
        for t in range(lk // bk):
            block = mask[q0:q0 + rows, t * bk:(t + 1) * bk]
            assert (t in visited) == bool(block.any()), (q0, t)
            assert (t in whole) == bool(block.all()), (q0, t)


# ---------------------------------------------------------------------------
# the gradient: ops.attention is an autograd Function (flash forward,
# reference-recompute backward), as the reference's custom_vjp
# ---------------------------------------------------------------------------

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)     # f32 grads of O(1) inputs


def test_attention_output_carries_its_grad_fn():
    """The same Function serves both devices, so the output has the
    Function's grad_fn on the CPU too; before it, the card's path (a
    ctypes launch into an empty tensor) dropped the gradient."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(9, 1, 2, 2, 32, 32, 16))
    out = ops.attention(q, k, v)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


GRAD_GRID = [(kw, lq, lk, group) for kw, lq, lk, group in GRID
             if (lq, lk) != (100, 100) or kw == dict(causal=True)]


@pytest.mark.parametrize("kw,lq,lk,group", GRAD_GRID,
                         ids=[_case_id(c) for c in GRAD_GRID])
def test_attention_grads_match_jax_grad_f32(kw, lq, lk, group):
    """dq, dk, dv against `jax.vjp` of the reference attention on the
    same cotangent: causal, bidirectional, window, softcap, GQA groups 1,
    2 and 4, ragged lengths."""
    import jax
    arrays = _inputs(10, 2, 2 * group, 2, lq, lk, 32)
    cot = np.random.RandomState(11).randn(2, 2 * group, lq, 32).astype(
        np.float32)
    (q, k, v), (jq, jk, jv) = _both(arrays, "float32")
    for t in (q, k, v):
        t.requires_grad_()
    ops.attention(q, k, v, **kw).backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, **kw),
                     jq, jk, jv)
    for t, want in zip((q, k, v), vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)
