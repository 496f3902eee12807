"""Kernel 5 (the combine + mean + AdamW update) and the fused
reduce-scatter -> AdamW path of the port, against the JAX package on the
CPU, on the same numpy inputs.

On the CPU the wrapper runs the kernel's plain version
(`ref.fused_adam_ref`): bit for bit equal to the reference's `_fused_ref`
called op by op (no jit, so no FMA contraction on either side).  The
Pallas kernel in interpret mode runs under XLA, which contracts a*b + c
into one FMA: there the tolerance is two f32 ulps of the larger term of
each output's last sum.  The CUDA kernel is held bit for bit to the
plain version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as jcoll
from repro.core import fusion as jfusion
from repro.core.netops import SimNetOps as JSim
from repro.core.topology import epiphany3 as jepiphany3
from repro.kernels import fused_update as jfu
from repro_torch.core import collectives as coll
from repro_torch.core import fusion
from repro_torch.core.netops import SimNetOps
from repro_torch.core.topology import epiphany3
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import ops, ref

HP = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd_coef=0.1)
OUT = {"f32": (torch.float32, jnp.float32),
       "bf16": (torch.bfloat16, jnp.bfloat16)}


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def bitwise(port, want):
    a, b = np_of(port), np_of(want)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def corrections(t: float):
    """(c1, c2) = 1 - beta**t in f32, the same values for both sides."""
    t = np.float32(t)
    return (np.float32(1) - np.float32(0.9) ** t,
            np.float32(1) - np.float32(0.95) ** t)


def chunks(seed, k, n):
    rng = np.random.default_rng(seed)
    gs = [rng.standard_normal(n).astype(np.float32) for _ in range(k)]
    p = rng.standard_normal(n).astype(np.float32)
    m = (rng.standard_normal(n) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 0.01).astype(np.float32)
    w = (rng.random(n) < 0.5).astype(np.int8)
    return gs, p, m, v, w


def run_both(gs, p, m, v, w, t, out, scale):
    c1, c2 = corrections(t)
    tdt, jdt = OUT[out]
    kw = dict(scale=scale, **HP)
    got = fu.fused_adam([torch.from_numpy(g) for g in gs],
                        torch.from_numpy(p), torch.from_numpy(m),
                        torch.from_numpy(v), torch.from_numpy(w),
                        torch.tensor(c1), torch.tensor(c2), out_dtype=tdt,
                        **kw)
    jargs = ([jnp.asarray(g) for g in gs], jnp.asarray(p), jnp.asarray(m),
             jnp.asarray(v), jnp.asarray(w), jnp.asarray(c1),
             jnp.asarray(c2))
    return got, jargs, dict(out_dtype=jdt, **kw)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 1000])
@pytest.mark.parametrize("n", [1000, 1003])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_plain_kernel5_equals_reference_ref_bitwise(k, n, t, out):
    gs, p, m, v, w = chunks(k * n + t, k, n)
    got, jargs, jkw = run_both(gs, p, m, v, w, t, out, scale=4.0)
    want = jfu._fused_ref(*jargs, **jkw)
    assert got[0].dtype == OUT[out][0]
    assert got[1].dtype == got[2].dtype == torch.float32
    for a, b in zip(got, want):
        bitwise(a, b)


def test_plain_kernel5_zero_gradient_and_moments():
    """g = 0 and v = 0: upd = 0 / (0 + eps) = 0, so only the decay moves
    p, as in the reference."""
    n = 64
    gs, p, _, _, w = chunks(1, 1, n)
    gs = [np.zeros(n, np.float32)]
    m, v = np.zeros(n, np.float32), np.zeros(n, np.float32)
    got, jargs, jkw = run_both(gs, p, m, v, w, 1, "f32", scale=1.0)
    for a, b in zip(got, jfu._fused_ref(*jargs, **jkw)):
        bitwise(a, b)
    assert torch.equal(got[0][w == 0], torch.from_numpy(p)[w == 0])


def ulps_of(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3])
def test_plain_kernel5_near_pallas_kernel_interpret(k, out):
    n = 1003
    gs, p, m, v, w = chunks(7 + k, k, n)
    got, jargs, jkw = run_both(gs, p, m, v, w, 1000, out, scale=4.0)
    want = jfu.fused_adam_update_2d(*jargs, interpret=True, **jkw)
    a = [np_of(x) for x in got]
    b = [np_of(x) for x in want]
    g = gs[0]
    for x in gs[1:]:
        g = g + x
    g = g / np.float32(4)
    c1, c2 = corrections(1000)
    upd = (a[1] / c1) / (np.sqrt(a[2] / c2) + np.float32(HP["eps"]))
    terms = [np.maximum(np.abs(p), np.abs(np.float32(HP["lr"]) * upd)),
             np.maximum(np.abs(np.float32(0.9) * m),
                        np.abs(np.float32(0.1) * g)),
             np.maximum(np.abs(np.float32(0.95) * v),
                        np.abs(np.float32(0.05) * g * g))]
    if out == "bf16":
        np.testing.assert_array_equal(a[0], b[0])
        terms = terms[1:]
        a, b = a[1:], b[1:]
    for x, y, term in zip(a, b, terms):
        assert (np.abs(x - y) <= 2 * ulps_of(term)).all()


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_combine_chunks_matches_reference(op, dtype):
    rng = np.random.default_rng(7)
    bufs = [rng.integers(-50, 50, size=(3, 40)).astype(dtype)
            for _ in range(3)]
    got = fu.combine_chunks([torch.from_numpy(b) for b in bufs], op)
    want = jfu.combine_chunks([jnp.asarray(b) for b in bufs], op,
                              use_pallas=False)
    bitwise(got, want)
    one = torch.from_numpy(bufs[0])
    assert fu.combine_chunks([one], op) is one


def _sim_inputs(n, total, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, total)).astype(np.float32)
    p = np.broadcast_to(rng.standard_normal(total).astype(np.float32),
                        (n, total)).copy()
    wd = (np.arange(total) < total // 2).astype(np.int8)
    chunk = -(-total // n)
    m = (rng.standard_normal((n, chunk)) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal((n, chunk))) * 0.01).astype(np.float32)
    return g, p, wd, m, v, chunk


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("total", [1000, 1003])     # even / ragged chunking
def test_fused_rs_adam_matches_reference_bitwise(total, out):
    """The port's fused_rs_adam + allgather_unpad on 4 SIM PEs equals the
    reference's, both un-jitted: the ring's stage combines, the owned
    chunk slicing and the update, value for value."""
    n = 4
    g, p, wd, m, v, _ = _sim_inputs(n, total, 1)
    c1, c2 = corrections(3)
    tdt, jdt = OUT[out]
    net = SimNetOps(n, device="cpu")
    new_p, new_m, new_v, info = fusion.fused_rs_adam(
        net, torch.from_numpy(g), torch.from_numpy(p), torch.from_numpy(m),
        torch.from_numpy(v), torch.from_numpy(wd), torch.tensor(c1),
        torch.tensor(c2), scale=float(n), out_dtype=tdt, **HP)
    full = coll.allgather_unpad(net, new_p, info)
    jnet = JSim(n)
    jp, jm, jv, jinfo = jfusion.fused_rs_adam(
        jnet, jnp.asarray(g), jnp.asarray(p), jnp.asarray(m),
        jnp.asarray(v), jnp.asarray(wd), jnp.asarray(c1), jnp.asarray(c2),
        scale=float(n), out_dtype=jdt, **HP)
    bitwise(full, jcoll.allgather_unpad(jnet, jp, jinfo))
    bitwise(new_m, jm)
    bitwise(new_v, jv)
    assert full.dtype == tdt


@pytest.mark.parametrize("total", [1000, 1003])
def test_port_fused_equals_unfused_bitwise(total):
    """fused_rs_adam + allgather == reduce_scatter + allgather_unpad + the
    plain AdamW on full moments (`test_fused.py`'s identity contract,
    here with nonzero moments): every PE holds the same updated bucket,
    and each PE's owned moment chunks are the matching slices of the
    full moments."""
    n = 4
    g, p, wd, m, v, chunk = _sim_inputs(n, total, 2)
    c1, c2 = corrections(5)
    net = SimNetOps(n, device="cpu")
    tg, tp = torch.from_numpy(g), torch.from_numpy(p)
    new_p, new_m, new_v, info = fusion.fused_rs_adam(
        net, tg, tp, torch.from_numpy(m), torch.from_numpy(v),
        torch.from_numpy(wd), c1, c2, scale=float(n), **HP)
    fused = coll.allgather_unpad(net, new_p, info)

    # the full moments every PE would hold: PE r owns chunk (r + 1) % n
    padded = chunk * n
    own = (np.arange(n) + 1) % n
    m_full = np.zeros(padded, np.float32)
    v_full = np.zeros(padded, np.float32)
    for r in range(n):
        m_full[own[r] * chunk:(own[r] + 1) * chunk] = m[r]
        v_full[own[r] * chunk:(own[r] + 1) * chunk] = v[r]
    mf = torch.from_numpy(np.tile(m_full[:total], (n, 1)))
    vf = torch.from_numpy(np.tile(v_full[:total], (n, 1)))
    g_sum = coll.allgather_unpad(net, *coll.reduce_scatter(net, tg))
    want_p, want_m, want_v = ref.fused_adam_ref(
        [g_sum], tp, mf, vf, torch.from_numpy(wd).expand(n, total), c1, c2,
        scale=float(n), out_dtype=torch.float32, **HP)
    bitwise(fused, want_p)
    assert all(torch.equal(fused[0], fused[r]) for r in range(n))
    for r in range(n):
        lo = own[r] * chunk
        valid = max(0, min(chunk, total - lo))
        bitwise(new_m[r, :valid], want_m[r, lo:lo + valid])
        bitwise(new_v[r, :valid], want_v[r, lo:lo + valid])


@pytest.mark.parametrize("n", [1, 4])
def test_fused_rs_adam_reaches_kernel5_through_ops_once(n, monkeypatch):
    """ops.fused_adam_update is the one entry of kernel 5 on the path: the
    update of every PE's chunk is one call, whatever the PE count."""
    calls = []
    real = ops.fused_adam_update

    def spy(g_bufs, p, *a, **kw):
        calls.append((len(g_bufs), tuple(p.shape)))
        return real(g_bufs, p, *a, **kw)

    monkeypatch.setattr(ops, "fused_adam_update", spy)
    g, p, wd, m, v, chunk = _sim_inputs(n, 1003, 4)
    c1, c2 = corrections(2)
    fusion.fused_rs_adam(
        SimNetOps(n, device="cpu"), torch.from_numpy(g), torch.from_numpy(p),
        torch.from_numpy(m), torch.from_numpy(v), torch.from_numpy(wd), c1,
        c2, scale=float(n), **HP)
    assert calls == [(1 if n == 1 else 2, (n, chunk))]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n,nbytes,topo", [
    (1, 1 << 20, None), (4, 1 << 16, None), (8, 1 << 22, None),
    (16, 64 << 20, None), (16, 64 << 20, "epiphany3"),
    (16, 4096, "epiphany3")])
def test_choose_grad_rs_matches_reference(n, nbytes, topo, itemsize):
    t = epiphany3() if topo else None
    jt = jepiphany3() if topo else None
    got = fusion.choose_grad_rs(n, nbytes, itemsize, topo=t)
    want = jfusion.choose_grad_rs(n, nbytes, itemsize, topo=jt)
    assert got == want


def test_choose_grad_rs_tuner_not_ported():
    with pytest.raises(NotImplementedError):
        fusion.choose_grad_rs(8, 1 << 22, 2, tuner=object())


def test_cpu_path_does_not_count_launches_and_ops_defaults():
    gs, p, m, v, w = chunks(3, 2, 100)
    before = fu.launches
    args = ([torch.from_numpy(g) for g in gs], torch.from_numpy(p),
            torch.from_numpy(m), torch.from_numpy(v), torch.from_numpy(w),
            0.1, 0.05)
    new_p, _, _ = ops.fused_adam_update(*args, **HP)
    assert new_p.dtype == torch.float32 and fu.launches == before
    bitwise(new_p, fu.fused_adam(*args, **HP)[0])


@pytest.mark.parametrize("change,exc", [
    (lambda a: {**a, "g_bufs": a["g_bufs"] * 3}, ValueError),     # k = 6
    (lambda a: {**a, "g_bufs": []}, ValueError),                  # k = 0
    (lambda a: {**a, "m": a["m"][:-1]}, ValueError),              # shape
    (lambda a: {**a, "p": a["p"].double()}, TypeError),           # dtype
    (lambda a: {**a, "wd_mask": a["wd_mask"].bool()}, TypeError),
    (lambda a: {**a, "out_dtype": torch.float16}, TypeError),
    (lambda a: {**a, "p": a["p"].reshape(2, 5, 10),
                "m": a["m"].reshape(2, 5, 10)}, ValueError),      # rank 3
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, exc):
    gs, p, m, v, w = chunks(4, 2, 100)
    a = dict(g_bufs=[torch.from_numpy(g) for g in gs], p=torch.from_numpy(p),
             m=torch.from_numpy(m), v=torch.from_numpy(v),
             wd_mask=torch.from_numpy(w), out_dtype=torch.float32)
    a = change(a)
    with pytest.raises(exc):
        fu.fused_adam(a["g_bufs"], a["p"], a["m"], a["v"], a["wd_mask"],
                      0.1, 0.05, out_dtype=a["out_dtype"], **HP)


def test_sqrt_rn_is_correctly_rounded():
    """The AdamW denominator's sqrt: the f32 root rounded to nearest, as
    numpy, JAX and the kernel's __fsqrt_rn give it, over inputs from
    1e-30 to 1e30 (this CPU build's torch.sqrt misses on some)."""
    rng = np.random.default_rng(12)
    x = (rng.random(100_003) * 10.0 ** rng.integers(-30, 30, 100_003)
         ).astype(np.float32)
    np.testing.assert_array_equal(ref.sqrt_rn(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))
    np.testing.assert_array_equal(np.sqrt(x), np.asarray(jnp.sqrt(x)))
