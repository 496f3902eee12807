"""The port's ShmemContext (`repro_torch.core.shmem`) against the JAX
package's on the SIM backend, on the CPU, on the same numpy inputs: RMA
(put/get, strided iput/iget, fan-out gets), the pending-op engine (nbi,
quiet, fence, per-context queues, team-scoped contexts), atomics, locks,
critical sections — and one 16-PE session on the paper's 4x4 mesh that
runs the runtime end to end with every intermediate compared.  Data
movement and integer payloads bit for bit; float reductions within
rtol 1e-4, atol 1e-5.  Mirrors test_shmem_api.py and the nbi/quiet/fence
tests of test_overlap.py and test_team.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as jcoll
from repro.core import sim_ctx as jsim_ctx
from repro.core import team as jteam
from repro.core.netops import SimNetOps as JSim
from repro.core.topology import epiphany3 as jepiphany3
from repro_torch.core import Profiler, Tuner, sim_ctx, spmd_ctx
from repro_torch.core import collectives as coll
from repro_torch.core import team as team_mod
from repro_torch.core.netops import SimNetOps
from repro_torch.core.shmem import DeadlineExceeded, ShmemContext
from repro_torch.core.topology import epiphany3

N = 8
FTOL = dict(rtol=1e-4, atol=1e-5)


def arr(t):
    if isinstance(t, torch.Tensor):
        return t.numpy()
    return np.asarray(t)


def same(port, ref, exact=True):
    a, b = arr(port), arr(ref)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                      a.dtype, b.dtype)
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, **FTOL)


def pair(x):
    return torch.from_numpy(np.array(x)), jnp.asarray(x)


@pytest.fixture
def ctxs():
    return sim_ctx(N, epiphany3(), device="cpu"), jsim_ctx(N, jepiphany3())


def _x(w=6, seed=0, n=N):
    return pair(np.random.RandomState(seed).randn(n, w).astype(np.float32))


# ---------------------------------------------------------------------------
# RMA
# ---------------------------------------------------------------------------

def test_put_get_iput_iget(ctxs):
    ctx, jctx = ctxs
    x, jx = _x()
    for pat in ([(0, 3)], [(i, (i + 1) % N) for i in range(N)],
                ctx.compile([(5, 2), (2, 5)])):
        jpat = pat if isinstance(pat, list) else list(pat.pairs)
        same(ctx.put(x, pat), jctx.put(jx, jpat))
        same(ctx.get(x, pat), jctx.get(jx, jpat))
    same(ctx.get(x, [(0, 2), (1, 2), (5, 2)]),          # fan-out read
         jctx.get(jx, [(0, 2), (1, 2), (5, 2)]))
    loc, jloc = _x(seed=1)
    same(ctx.put(x, [(0, 3)], local=loc), jctx.put(jx, [(0, 3)], local=jloc))
    y, jy = pair(np.arange(N * 8, dtype=np.float32).reshape(N, 8))
    same(ctx.iput(y, [(0, 1)], sst=2, dst=2, nelems=4),
         jctx.iput(jy, [(0, 1)], sst=2, dst=2, nelems=4))
    same(ctx.iput(y, [(3, 6)], sst=3, dst=1),
         jctx.iput(jy, [(3, 6)], sst=3, dst=1))
    same(ctx.iget(y, [(5, 2)], sst=1, dst=1, nelems=4),
         jctx.iget(jy, [(5, 2)], sst=1, dst=1, nelems=4))
    assert ctx.ptr(19, 128) == jctx.ptr(19, 128)
    same(coll.get(SimNetOps(N, "cpu"), x, [(0, 2), (1, 2)]),
         jcoll.get(JSim(N), jx, [(0, 2), (1, 2)]))


# ---------------------------------------------------------------------------
# the pending-op engine
# ---------------------------------------------------------------------------

def test_nbi_quiet_in_issue_order(ctxs):
    ctx, jctx = ctxs
    x, jx = _x()
    fs = [ctx.put_nbi(x, [(0, 1)]), ctx.put_nbi(x, [(2, 3)]),
          ctx.get_nbi(x, [(4, 5)])]
    jfs = [jctx.put_nbi(jx, [(0, 1)]), jctx.put_nbi(jx, [(2, 3)]),
           jctx.get_nbi(jx, [(4, 5)])]
    assert ctx.pending_count == 3 and [f.seq for f in fs] == [0, 1, 2]
    assert [f.target_pes() for f in fs] == [f.target_pes() for f in jfs]
    assert [f.nbytes for f in fs] == [f.nbytes for f in jfs]
    assert [f.op for f in fs] == ["put", "put", "get"]
    vals, jvals = ctx.quiet(fs[2], fs[0]), jctx.quiet(jfs[2], jfs[0])
    assert fs[0].done and fs[2].done and not fs[1].done
    assert ctx.pending_ops() == (fs[1],)
    for v, jv in zip(vals, jvals):            # issue order, not call order
        same(v, jv)
    same(vals[0], ctx.put(x, [(0, 1)]))
    vals, jvals = ctx.quiet(), jctx.quiet()
    assert len(vals) == 1 and ctx.pending_count == 0 and fs[1].done
    same(vals[0], jvals[0])
    assert ctx.quiet() == ()


def test_fence_orders_without_completing(ctxs):
    ctx, jctx = ctxs
    x, jx = _x()
    fs = [ctx.put_nbi(x, [(0, 3)]), ctx.put_nbi(2 * x, [(1, 3)]),
          ctx.put_nbi(x, [(4, 5)])]
    jfs = [jctx.put_nbi(jx, [(0, 3)]), jctx.put_nbi(2 * jx, [(1, 3)]),
           jctx.put_nbi(jx, [(4, 5)])]
    vals, jvals = ctx.fence(), jctx.fence()
    assert len(vals) == 3 and ctx.pending_count == 3
    assert not any(f.done for f in fs)
    for v, jv in zip(vals, jvals):
        same(v, jv)
    ctx.quiet(), jctx.quiet()
    assert all(f.done for f in fs) and ctx.fence() == ()
    for f, jf in zip(fs, jfs):
        same(f.value, jf.value)


def test_contexts_isolate_their_queues(ctxs):
    ctx, _ = ctxs
    x, _ = _x()
    c1, c2 = ctx.ctx_create(), ctx.ctx_create()
    f1, f2 = c1.put_nbi(x, [(0, 1)]), c2.put_nbi(x, [(2, 3)])
    fd = ctx.put_nbi(x, [(4, 5)])
    assert (f1.seq, f2.seq, fd.seq) == (0, 0, 0)
    c2.quiet()
    assert f2.done and not f1.done and not fd.done
    with pytest.raises(ValueError):
        ctx.quiet(f1)                  # the default context must not drain it
    assert c1.fence() == (f1.value,) and not f1.done
    ctx.quiet()
    assert fd.done and not f1.done
    c1.quiet()
    c1.quiet(f1)                       # a completed future passes through
    assert f1.done and c1.pending_count == 0
    with pytest.raises(DeadlineExceeded):
        f = c1.put_nbi(x, [(0, 1)])
        f.delay_s = 1.0                # a straggler beyond the deadline
        c1.quiet(deadline_s=0.5)
    assert c1.pending_count == 1       # the queue is untouched


def test_team_scoped_context(ctxs):
    ctx, jctx = ctxs
    t = team_mod.make_team((1, 4, 7), N)
    jt = jteam.make_team((1, 4, 7), N)
    tc, jtc = ctx.ctx_create(team=t), jctx.ctx_create(team=jt)
    x, jx = _x(seed=11)
    f, jf = tc.put_nbi(x, [(0, 2)]), jtc.put_nbi(jx, [(0, 2)])
    assert f.target_pes() == jf.target_pes() == (7,)
    g, jg = tc.get_nbi(x, [(0, 1)]), jtc.get_nbi(jx, [(0, 1)])
    assert g.target_pes() == jg.target_pes() == (1,)
    for v, jv in zip(tc.quiet(), jtc.quiet()):
        same(v, jv)


# ---------------------------------------------------------------------------
# atomics, locks, critical sections
# ---------------------------------------------------------------------------

def test_atomics_locks_critical(ctxs):
    ctx, jctx = ctxs
    var, jvar = pair((np.arange(N) * 10).astype(np.int32))
    val, jval = pair(np.full((N,), 7, np.int32))
    ring = [(i, (i + 1) % N) for i in range(N)]
    for a, b in zip(ctx.atomic_swap(var, val, ring),
                    jctx.atomic_swap(jvar, jval, ring)):
        same(a, b)
    cond, jcond = pair(np.where(np.arange(N) % 2 == 0, 10, -1)
                       .astype(np.int32))
    for c, jc in ((cond, jcond), (cond - 1, jcond - 1)):
        for a, b in zip(ctx.atomic_compare_swap(var, c, val, [(0, 1)]),
                        jctx.atomic_compare_swap(jvar, jc, jval, [(0, 1)])):
            same(a, b)
    one, jone = pair(np.ones((N,), np.int32))
    for a, b in zip(ctx.atomic_fetch_add(var, one, ring),
                    jctx.atomic_fetch_add(jvar, jone, ring)):
        same(a, b)
    for a, b in zip(ctx.atomic_fetch_add_shared(var, one),
                    jctx.atomic_fetch_add_shared(jvar, jone)):
        same(a, b)
    zero, jzero = pair(np.array([0, 5, 0, 1] * 2, np.int32))
    for a, b in zip(ctx.testset(zero, val), jctx.testset(jzero, jval)):
        same(a, b)
    lock, jlock = pair(np.zeros((N,), np.int32))
    want, jwant = pair(np.array([0, 1, 1, 0, 1, 0, 0, 0], bool))
    g, new = ctx.set_lock(lock, want)
    jg, jnew = jctx.set_lock(jlock, jwant)
    same(g, jg)
    same(new, jnew)
    rel, jrel = pair(np.ones((N,), bool))
    same(ctx.clear_lock(new, rel), jctx.clear_lock(jnew, jrel))
    held, jheld = pair(np.full((N,), 3, np.int32))
    for a, b in zip(ctx.test_lock(held, rel), jctx.test_lock(jheld, jrel)):
        same(a, b)
    s, js = pair(np.zeros((N,), np.float32))
    same(ctx.critical(s, lambda v: v + 1), jctx.critical(js, lambda v: v + 1))


def test_entry_points_and_device_rules():
    x = torch.zeros((4, 3))
    ctx = sim_ctx(4, device="cpu")
    assert ctx.device == torch.device("cpu")
    with pytest.raises(ValueError):
        ctx.put(x[:3], [(0, 1)])               # no leading axis of 4 PEs
    with pytest.raises(ValueError):
        ctx.put(torch.zeros((4, 3), device="meta"), [(0, 1)])
    with pytest.raises(NotImplementedError):
        spmd_ctx("pe")
    with pytest.raises(NotImplementedError, match="fault injector"):
        ShmemContext(SimNetOps(4, "cpu"), fault=object())
    # the profiler and the tuner are ported: the context takes them and
    # the executors note their selection on the open op
    prof, tuner = Profiler(level=2), Tuner()
    c = ShmemContext(SimNetOps(4, "cpu"), profile=prof, tuner=tuner,
                     fingerprint="fp:test")
    assert c.net.profile is prof and c._sel.db is tuner.db
    c.broadcast(torch.ones((4, 3)))
    (s,) = prof.samples
    assert (s.collective, s.algorithm, s.fingerprint) == \
        ("broadcast", "binomial_ff", "fp:test")
    prof2 = Profiler(level=2)
    with prof2.op("broadcast", n_pes=4):
        coll.broadcast(ctx.net, torch.ones((4, 3)), profile=prof2)
    assert prof2.samples[0].schedule.startswith("broadcast")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim_ctx(4)                         # CUDA by default, no fallback


# ---------------------------------------------------------------------------
# one 16-PE session on the paper's chip, end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noc", [False, True])
def test_sixteen_pe_session(noc):
    """put -> get -> 3 x put_nbi + quiet -> barrier_all -> broadcast ->
    fcollect -> to_all (rd and ring, i32 and f32) -> reduce_scatter +
    allgather_unpad -> alltoall, each result compared with the JAX
    package's on the same inputs."""
    n = 16
    ctx = sim_ctx(n, epiphany3(), noc=noc, device="cpu")
    jctx = jsim_ctx(n, jepiphany3(), noc=noc)
    rng = np.random.RandomState(16)
    xi, jxi = pair(rng.randint(-9999, 9999, (n, 64)).astype(np.int32))
    xf, jxf = pair(rng.randn(n, 64).astype(np.float32))
    ring = [(i, (i + 1) % n) for i in range(n)]
    same(ctx.put(xi, ring), jctx.put(jxi, ring))
    same(ctx.get(xf, [(3, 12), (12, 3), (0, 15)]),
         jctx.get(jxf, [(3, 12), (12, 3), (0, 15)]))
    pats = [[(0, 5)], ring, [(i, 15 - i) for i in range(n)]]
    for p in pats:
        ctx.put_nbi(xi, p)
        jctx.put_nbi(jxi, p)
    for v, jv in zip(ctx.quiet(), jctx.quiet()):
        same(v, jv)
    same(ctx.barrier_all(), jctx.barrier_all())
    same(ctx.broadcast(xf, 9), jctx.broadcast(jxf, 9))
    same(ctx.fcollect(xi), jctx.fcollect(jxi))
    for algo in ("rd", "ring"):
        same(ctx.to_all(xi, "sum", algorithm=algo),
             jctx.to_all(jxi, "sum", algorithm=algo))
        same(ctx.to_all(xf, "sum", algorithm=algo),
             jctx.to_all(jxf, "sum", algorithm=algo), exact=False)
        np.testing.assert_array_equal(
            ctx.to_all(xi, "sum", algorithm=algo).numpy(),
            np.tile(xi.numpy().sum(0, dtype=np.int32), (n, 1)))
    own, info = ctx.reduce_scatter(xi)
    jown, jinfo = jctx.reduce_scatter(jxi)
    same(own, jown)
    same(coll.allgather_unpad(ctx.net, own, info),
         jcoll.allgather_unpad(jctx.net, jown, jinfo))
    a, ja = pair(rng.randint(-99, 99, (n, 3 * n)).astype(np.int32))
    same(ctx.alltoall(a), jctx.alltoall(ja))
