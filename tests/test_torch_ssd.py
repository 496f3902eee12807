"""Kernel 7's plain versions and `ops.ssd` on the CPU against the JAX
package's SSD references, on the same numpy inputs.

The port is held to `repro.kernels.ref.ssd_ref` (the sequential scan) at
`tests/test_kernels.py`'s atol 2e-4, and to `ref.ssd_chunked_ref` /
`ops.ssd(use_pallas=False)` (the same chunked math) at rtol 1e-4, atol
1e-5.  So is the chunk-parallel decomposition of the kernel (chunk
states, state passing, chunk outputs), whose entering states are held
to the reference's final state over each prefix of chunks.  The reference's Pallas interpret path is not used: it is red under
this JAX (no `pl.load`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kssd

SCAN_TOL = dict(atol=2e-4)
CHUNK_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, B, L, H, P, N, G, h0=False):
    """tests/test_kernels.py's scales: x, B, C at 0.3, dt in [0, 0.5),
    A in (-1.1, -0.1], h0 at 0.2."""
    rng = np.random.RandomState(seed)
    out = [(rng.randn(B, L, H, P) * .3).astype(np.float32),
           (rng.rand(B, L, H) * .5).astype(np.float32),
           (-rng.rand(H) - .1).astype(np.float32),
           (rng.randn(B, L, G, N) * .3).astype(np.float32),
           (rng.randn(B, L, G, N) * .3).astype(np.float32)]
    out.append((rng.randn(B, H, P, N) * .2).astype(np.float32) if h0
               else None)
    return out


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


SHAPES = [(64, 16), (64, 64), (48, 16)]          # (L, chunk) of test_kernels


@pytest.mark.parametrize("L,chunk", SHAPES)
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_ref_matches_jax(L, chunk, groups):
    a = _inputs(0, 2, L, 4, 16, 8, groups)
    y, h = ref.ssd_chunked_ref(*map(_t, a), chunk=chunk)
    jy, jh = jref.ssd_chunked_ref(*map(_j, a), chunk=chunk)
    close(y, jy, **CHUNK_TOL)
    close(h, jh, **CHUNK_TOL)
    sy, sh = jref.ssd_ref(*map(_j, a))
    close(y, sy, **SCAN_TOL)
    close(h, sh, **SCAN_TOL)


@pytest.mark.parametrize("L", [64, 48])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_scan_oracle_matches_jax(L, groups):
    a = _inputs(1, 2, L, 4, 16, 8, groups)
    y, h = ref.ssd_ref(*map(_t, a))
    jy, jh = jref.ssd_ref(*map(_j, a))
    close(y, jy, **CHUNK_TOL)
    close(h, jh, **CHUNK_TOL)


@pytest.mark.parametrize("L,chunk", SHAPES)
@pytest.mark.parametrize("groups", [1, 2])
def test_ops_ssd_matches_jax_ops_and_scan(L, chunk, groups):
    """test_kernels.py::test_ssd_kernel_and_chunked_vs_scan's cases."""
    a = _inputs(2, 2, L, 4, 16, 8, groups)
    y, h = ops.ssd(*map(_t, a[:5]), chunk=chunk)
    assert y.shape == (2, L, 4, 16) and h.shape == (2, 4, 16, 8)
    jy, jh = jops.ssd(*map(_j, a[:5]), chunk=chunk, use_pallas=False)
    close(y, jy, **CHUNK_TOL)
    close(h, jh, **CHUNK_TOL)
    sy, sh = jref.ssd_ref(*map(_j, a[:5]))
    close(y, sy, **SCAN_TOL)
    close(h, sh, **SCAN_TOL)


@pytest.mark.parametrize("L,chunk", [(50, 16), (7, 8), (130, 128)])
def test_ops_ssd_ragged_lengths(L, chunk):
    a = _inputs(3, 1, L, 2, 8, 4, 1, h0=True)
    y, h = ops.ssd(*map(_t, a), chunk=chunk)
    jy, jh = jops.ssd(*map(_j, a), chunk=chunk, use_pallas=False)
    close(y, jy, **CHUNK_TOL)
    close(h, jh, **CHUNK_TOL)
    sy, sh = jref.ssd_ref(*map(_j, a))
    close(y, sy, **SCAN_TOL)
    close(h, sh, **SCAN_TOL)


def test_ssd_with_initial_state():
    """test_kernels.py::test_ssd_with_initial_state's shapes."""
    a = _inputs(4, 1, 32, 2, 8, 4, 1, h0=True)
    y, h = ops.ssd(*map(_t, a), chunk=8)
    sy, sh = jref.ssd_ref(*map(_j, a))
    close(y, sy, **SCAN_TOL)
    close(h, sh, **SCAN_TOL)
    jy, jh = jops.ssd(*map(_j, a), chunk=8, use_pallas=False)
    close(y, jy, **CHUNK_TOL)
    close(h, jh, **CHUNK_TOL)


def test_ssd_bf16_inputs_give_bf16_y_and_f32_state():
    a = _inputs(5, 1, 32, 2, 8, 4, 1)
    x, dt, al, b, c, _ = map(_t, a)
    y, h = ops.ssd(x.bfloat16(), dt, al, b.bfloat16(), c.bfloat16(), chunk=8)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    want, _ = ref.ssd_chunked_ref(x.bfloat16().float(), dt, al,
                                  b.bfloat16().float(), c.bfloat16().float(),
                                  chunk=8)
    torch.testing.assert_close(y, want.bfloat16(), rtol=0, atol=0)


def test_ssd_output_carries_its_grad_fn():
    a = [t.requires_grad_() if t is not None else t
         for t in map(_t, _inputs(6, 1, 16, 2, 8, 4, 1))]
    y, h = ops.ssd(*a[:5], chunk=8)
    assert y.grad_fn is not None and h.grad_fn is not None


@pytest.mark.parametrize("L,chunk,groups,with_h0",
                         [(32, 8, 1, True), (20, 8, 2, False),
                          (48, 16, 2, True)])
def test_ssd_grads_match_jax_grad(L, chunk, groups, with_h0):
    """Every input's gradient through ops.ssd (kernel forward, chunked
    reference-recompute backward) against jax.grad of the reference's
    differentiable path (`ops.ssd(use_pallas=False)` =
    `ref.ssd_chunked_ref` on the padded inputs)."""
    a = _inputs(7, 2, L, 4, 8, 4, groups, h0=with_h0)
    rng = np.random.RandomState(8)
    gy = rng.randn(2, L, 4, 8).astype(np.float32)
    gh = rng.randn(2, 4, 8, 4).astype(np.float32)
    n_in = 6 if with_h0 else 5

    def jloss(*args):
        y, h = jops.ssd(*args, chunk=chunk, use_pallas=False)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    jgrads = jax.grad(jloss, argnums=tuple(range(n_in)))(
        *map(_j, a[:n_in]))
    ts = [_t(v).requires_grad_() for v in a[:n_in]]
    y, h = ops.ssd(*ts, chunk=chunk)
    ((y * _t(gy)).sum() + (h * _t(gh)).sum()).backward()
    for t, jg in zip(ts, jgrads):
        close(t.grad, jg, rtol=1e-4, atol=1e-5)


def test_ssd_backward_is_finite_for_large_decays():
    """The mask in the exponent: with |A| dt large, exp(s_t - s_u) above
    the diagonal would overflow; the gradient stays finite."""
    a = _inputs(9, 1, 16, 2, 4, 4, 1)
    a[2] = np.array([-40.0, -80.0], np.float32)
    a[1] = np.full_like(a[1], 2.0)
    ts = [_t(v).requires_grad_() for v in a[:5]]
    y, h = ops.ssd(*ts, chunk=8)
    (y.sum() + h.sum()).backward()
    for t in ts:
        assert torch.isfinite(t.grad).all()


def test_cpu_path_does_not_count_launches():
    before = kssd.launches
    a = map(_t, _inputs(10, 1, 16, 2, 8, 4, 1))
    kssd.ssd_scan(*a, chunk=8)
    assert kssd.launches == before


def test_wrapper_refuses_devices_without_a_kernel():
    x, dt, al, b, c, _ = (t.to("meta") if t is not None else None
                          for t in map(_t, _inputs(11, 1, 16, 2, 8, 4, 1)))
    with pytest.raises(ValueError, match="no kernel"):
        kssd.ssd_scan(x, dt, al, b, c, chunk=8)


def _args(**change):
    """Valid wrapper arguments (x, dt, a_log, b, c, h0) with `change`
    applied, by name."""
    names = ("x", "dt", "a_log", "b", "c", "h0")
    a = dict(zip(names, map(_t, _inputs(12, 1, 16, 4, 8, 4, 2, h0=True))))
    a.update(change)
    return [a[k] for k in names]


BAD = {
    "x f64": (dict(x=torch.zeros(1, 16, 4, 8, dtype=torch.float64)),
              TypeError),
    "b bf16 x f32": (dict(b=torch.zeros(1, 16, 2, 4, dtype=torch.bfloat16)),
                     TypeError),
    "dt bf16": (dict(dt=torch.zeros(1, 16, 4, dtype=torch.bfloat16)),
                TypeError),
    "H % G": (dict(b=torch.zeros(1, 16, 3, 4), c=torch.zeros(1, 16, 3, 4)),
              ValueError),
    "a_log shape": (dict(a_log=torch.zeros(3)), ValueError),
    "h0 shape": (dict(h0=torch.zeros(1, 4, 8, 5)), ValueError),
    "P % 4": (dict(x=torch.zeros(1, 16, 4, 6),
                   h0=torch.zeros(1, 4, 6, 4)), ValueError),
    "P > 64": (dict(x=torch.zeros(1, 16, 4, 68),
                    h0=torch.zeros(1, 4, 68, 4)), ValueError),
    "N > 128": (dict(b=torch.zeros(1, 16, 2, 132),
                     c=torch.zeros(1, 16, 2, 132),
                     h0=torch.zeros(1, 4, 8, 132)), ValueError),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    change, exc = BAD[case]
    with pytest.raises(exc):
        kssd.ssd_scan(*_args(**change), chunk=8)


@pytest.mark.parametrize("chunk", [6, 12, 256])
def test_wrapper_rejects_chunks_the_kernel_does_not_take(chunk):
    with pytest.raises(ValueError, match="chunk"):
        kssd.ssd_scan(*_args(), chunk=chunk)


# ---------------------------------------------------------------------------
# the chunk-parallel decomposition (csrc/ssd_scan.cu's three phases)
# ---------------------------------------------------------------------------

def _phases(t, chunk):
    """The three plain phases on torch inputs (x, dt, a, b, c, h0)."""
    s, local = ref.ssd_chunk_states_ref(t[0], t[1], t[2], t[3], chunk)
    entering, final = ref.ssd_state_passing_ref(local, s, t[5])
    y = ref.ssd_chunk_outputs_ref(t[0], t[1], t[3], t[4], s, entering,
                                  chunk)
    return s, local, entering, final, y


def _jax_entering(a, chunk, c):
    """The state entering chunk c: h0 (or 0), else the reference's final
    state over the first c chunks."""
    if c == 0:
        return (np.zeros((a[0].shape[0], a[0].shape[2], a[0].shape[3],
                          a[3].shape[3]), np.float32) if a[5] is None
                else a[5])
    cut = c * chunk
    pre = [v[:, :cut] for v in (a[0], a[1])] + [a[2]] \
        + [v[:, :cut] for v in (a[3], a[4])] + [a[5]]
    return jref.ssd_chunked_ref(*map(_j, pre), chunk=chunk)[1]


@pytest.mark.parametrize("L,chunk", SHAPES)
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_h0", [False, True])
def test_chunk_parallel_phases_match_jax(L, chunk, groups, with_h0):
    """y and the final state of the three phases against the reference's
    chunked and sequential scans, and the state entering every chunk
    against the reference's final state over the chunks before it."""
    a = _inputs(13, 2, L, 4, 16, 8, groups, h0=with_h0)
    s, local, entering, final, y = _phases(list(map(_t, a)), chunk)
    nc = L // chunk
    assert s.shape == (2, nc, 4, chunk) and local.shape == (2, nc, 4, 16, 8)
    assert entering.shape == local.shape and y.shape == (2, L, 4, 16)
    jy, jh = jref.ssd_chunked_ref(*map(_j, a), chunk=chunk)
    close(y, jy, **CHUNK_TOL)
    close(final, jh, **CHUNK_TOL)
    sy, sh = jref.ssd_ref(*map(_j, a))
    close(y, sy, **SCAN_TOL)
    close(final, sh, **SCAN_TOL)
    for c in range(nc):
        close(entering[:, c], _jax_entering(a, chunk, c), **CHUNK_TOL)


@pytest.mark.parametrize("L,chunk", [(50, 16), (7, 8), (130, 128)])
def test_chunk_parallel_phases_ragged_lengths(L, chunk):
    """Padded to the chunk as ops.ssd pads (dt = 0 leaves the state
    alone): y[:L] and the final state against the reference's ops.ssd."""
    a = _inputs(14, 1, L, 2, 8, 4, 1, h0=True)
    t = list(map(_t, a))
    t[0], t[1], t[3], t[4] = ops._ssd_pad(t[0], t[1], t[3], t[4], chunk)
    _, _, _, final, y = _phases(t, chunk)
    jy, jh = jops.ssd(*map(_j, a), chunk=chunk, use_pallas=False)
    close(y[:, :L], jy, **CHUNK_TOL)
    close(final, jh, **CHUNK_TOL)
    sy, sh = jref.ssd_ref(*map(_j, a))
    close(y[:, :L], sy, **SCAN_TOL)
    close(final, sh, **SCAN_TOL)


def test_ssd_scan_phases_cpu_path_is_the_plain_decomposition():
    """On the CPU the wrapper's intermediates are the plain phases; its y
    and final state agree with the reference's chunked scan and with the
    port's plain chunked version."""
    a = _inputs(15, 2, 64, 4, 16, 8, 2, h0=True)
    t = list(map(_t, a))
    got = kssd.ssd_scan_phases(*t, chunk=16)
    s, local, entering, final, y = _phases(t, 16)
    for key, want in (("s", s), ("chunk_states", local),
                      ("entering", entering), ("final", final), ("y", y)):
        torch.testing.assert_close(got[key], want, rtol=0, atol=0)
    jy, jh = jref.ssd_chunked_ref(*map(_j, a), chunk=16)
    close(got["y"], jy, **CHUNK_TOL)
    close(got["final"], jh, **CHUNK_TOL)
    wy, wh = ref.ssd_chunked_ref(*t, chunk=16)
    close(got["y"], wy.numpy(), **CHUNK_TOL)
    close(got["final"], wh.numpy(), **CHUNK_TOL)


def test_chunk_states_take_a_given_cumsum():
    """Phase 1 given its own cumsums gives its own local states, and given
    other cumsums other ones (the hook that holds a kernel's product on
    the kernel's s)."""
    t = list(map(_t, _inputs(16, 1, 32, 2, 8, 4, 1)))
    s, local = ref.ssd_chunk_states_ref(t[0], t[1], t[2], t[3], 8)
    s2, local2 = ref.ssd_chunk_states_ref(t[0], t[1], t[2], t[3], 8, s=s)
    torch.testing.assert_close(s2, s, rtol=0, atol=0)
    torch.testing.assert_close(local2, local, rtol=0, atol=0)
    _, other = ref.ssd_chunk_states_ref(t[0], t[1], t[2], t[3], 8,
                                        s=s * 0.5)
    assert not torch.allclose(other, local)
