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
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 2, 32, 64, 16))
    out = fa.flash_attention(q, k, v, causal=False, lk_valid=0)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, v.mean(2, keepdim=True).expand_as(out))


def test_cpu_path_does_not_count_launches():
    before = fa.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 2, 2, 32, 64, 16))
    fa.flash_attention(q, k, v)
    assert fa.launches == before


@pytest.mark.parametrize("change,exc", [
    (lambda q, k, v: (q.half(), k.half(), v.half()), TypeError),
    (lambda q, k, v: (q[:, :, :16], k, v), ValueError),          # Lq % 32
    (lambda q, k, v: (q, k[:, :, :40], v[:, :, :40]), ValueError),  # Lk % 64
    (lambda q, k, v: (q.transpose(2, 3).contiguous().transpose(2, 3), k, v),
     ValueError),                                                # strides
    (lambda q, k, v: (q[..., :8].contiguous(), k[..., :8].contiguous(),
                      v[..., :8].contiguous()), ValueError),     # head dim
    (lambda q, k, v: (q[:, :1], k, v), ValueError),              # Hq % Hkv
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, exc):
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 2, 2, 32, 64, 16))
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
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 2, 2, 32, 64, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, **kw)


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
