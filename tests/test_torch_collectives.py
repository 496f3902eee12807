"""The port's §3.6 collectives (`repro_torch.core.collectives`) against
`repro.core.collectives` on the SIM backend, on the CPU, on the same
numpy inputs.

Data movement and integer reductions must match bit for bit; float
reductions within rtol 1e-4, atol 1e-5 (the two frameworks may sum in a
different order only where the reference leaves it to XLA: never inside
a stage, whose combine is one elementwise op, so most float results are
equal too).  Mirrors test_collectives.py, test_team.py, test_overlap.py
and test_congestion.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as jcoll
from repro.core import netops as jnetops
from repro.core import sim_ctx as jsim_ctx
from repro.core import team as jteam
from repro.core.topology import MeshTopology as JMesh
from repro_torch.core import collectives as coll
from repro_torch.core import netops
from repro_torch.core import sim_ctx
from repro_torch.core import team as team_mod
from repro_torch.core.topology import MeshTopology, epiphany3

FTOL = dict(rtol=1e-4, atol=1e-5)


def arr(t):
    """numpy of a torch tensor or jax array (bf16 as f32)."""
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def same(port, ref, exact=True):
    a, b = arr(port), arr(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, **FTOL)


def data(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == np.int32:
        return rng.randint(-99, 99, shape).astype(np.int32)
    return rng.randn(*shape).astype(dtype)


def pair(x):
    return torch.from_numpy(x.copy()), jnp.asarray(x)


def nets(n, noc=False, topo=None):
    if noc:
        return (netops.NocSimNetOps(n, "cpu", topo=topo),
                jnetops.NocSimNetOps(n, topo=jtopo(topo)))
    return netops.SimNetOps(n, "cpu"), jnetops.SimNetOps(n)


def jtopo(topo):
    if topo is None:
        return None
    return JMesh(topo.shape, topo.torus, topo.link_cost)


def jteam_of(team):
    if isinstance(team, team_mod.TeamPartition):
        return jteam.TeamPartition([jteam_of(t) for t in team.teams])
    return jteam.make_team(team.members, team.world_n)


NS = [1, 2, 3, 4, 5, 8, 16, 17]


# ---------------------------------------------------------------------------
# flat collectives, every algorithm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_broadcast_fcollect_collect_alltoall_bitwise(n):
    net, jnet = nets(n)
    x, jx = pair(data((n, 5), np.float32, seed=n))
    for root in {0, n // 2, n - 1}:
        same(coll.broadcast(net, x, root), jcoll.broadcast(jnet, jx, root))
    for algo in (None, "ring", "auto") + (("rd",) if n & (n - 1) == 0
                                          else ()):
        same(coll.fcollect(net, x, algorithm=algo),
             jcoll.fcollect(jnet, jx, algorithm=algo))
    same(coll.collect(net, x), jcoll.collect(jnet, jx))
    a, ja = pair(data((n, 2 * n, 3), np.int32, seed=n + 1))
    same(coll.alltoall(net, a), jcoll.alltoall(jnet, ja))
    same(coll.alltoall(net, a.transpose(1, 2).contiguous(), axis=1),
         jcoll.alltoall(jnet, jnp.swapaxes(ja, 1, 2), axis=1))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("op", ["sum", "prod", "max", "min"])
def test_allreduce_every_algorithm(n, op):
    net, jnet = nets(n)
    algos = [None, "ring", "auto"] + (["rd"] if n & (n - 1) == 0 else [])
    xi, jxi = pair(data((n, 9), np.int32, seed=n))
    if op == "prod":
        xi, jxi = pair((data((n, 9), np.int32, seed=n) % 3).astype(np.int32))
    xf, jxf = pair(data((n, 9), np.float32, seed=n))
    if op == "prod":
        xf, jxf = pair(np.abs(data((n, 9), np.float32, seed=n)) * .5 + .5)
    for algo in algos:
        same(coll.allreduce(net, xi, op, algorithm=algo),
             jcoll.allreduce(jnet, jxi, op, algorithm=algo))
        same(coll.allreduce(net, xf, op, algorithm=algo),
             jcoll.allreduce(jnet, jxf, op, algorithm=algo), exact=False)


@pytest.mark.parametrize("n", [2, 3, 4, 6, 8, 16])
def test_reduce_scatter_allgather_unpad(n):
    net, jnet = nets(n)
    for dtype, exact in ((np.int32, True), (np.float32, False)):
        x, jx = pair(data((n, 3, 7), dtype, seed=n))
        own, info = coll.reduce_scatter(net, x, "sum")
        jown, jinfo = jcoll.reduce_scatter(jnet, jx, "sum")
        same(own, jown, exact)
        assert info[:3] == tuple(jinfo[:3])
        np.testing.assert_array_equal(info[3], np.asarray(jinfo[3]))
        same(coll.allgather_unpad(net, own, info),
             jcoll.allgather_unpad(jnet, jown, jinfo), exact)
        loc, inc, _, _ = coll._reduce_scatter_parts(net, x, coll.OPS["sum"])
        jloc, jinc, _, _ = jcoll._reduce_scatter_parts(jnet, jx,
                                                       jcoll.OPS["sum"])
        same(loc, jloc, exact)
        same(inc, jinc, exact)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_barrier_and_exclusive_scan(n):
    net, jnet = nets(n)
    for algo in ("dissem", "tree", "auto"):
        same(coll.barrier(net, algorithm=algo),
             jcoll.barrier(jnet, algorithm=algo))
    tok, jtok = pair(np.arange(n, dtype=np.int32) * 3)
    same(coll.barrier(net, tok, algorithm="tree"),
         jcoll.barrier(jnet, jtok, algorithm="tree"))
    xi, jxi = pair(data((n,), np.int32, seed=n))
    for op in ("sum", "and", "or", "xor"):
        same(coll.exclusive_scan(net, xi, op),
             jcoll.exclusive_scan(jnet, jxi, op))
    xf, jxf = pair(data((n, 3), np.float32, seed=n))
    for op in ("sum", "prod", "max", "min"):
        same(coll.exclusive_scan(net, xf, op),
             jcoll.exclusive_scan(jnet, jxf, op), exact=False)


def test_dtypes_keep_themselves():
    n = 6
    net, jnet = nets(n)
    for dtype in (np.int32, np.float32, np.bool_):
        raw = data((n, 4), np.int32, seed=3) % 2 if dtype == np.bool_ \
            else data((n, 4), dtype, seed=3)
        x, jx = pair(raw.astype(dtype))
        same(coll.collect(net, x), jcoll.collect(jnet, jx))
        same(coll.alltoall(net, torch.cat([x] * 3, 1)),
             jcoll.alltoall(jnet, jnp.concatenate([jx] * 3, 1)))
    x, jx = pair(data((n, 4), np.float32, seed=4))
    same(coll.allreduce(net, x.to(torch.bfloat16), "max"),
         jcoll.allreduce(jnet, jx.astype(jnp.bfloat16), "max"))
    same(coll.allreduce(net, x.to(torch.bfloat16), "sum", algorithm="ring"),
         jcoll.allreduce(jnet, jx.astype(jnp.bfloat16), "sum",
                         algorithm="ring"))
    xb, jxb = pair(data((n, 4), np.int32, seed=5) > 0)
    same(coll.allreduce(net, xb, "or"), jcoll.allreduce(jnet, jxb, "or"))


# ---------------------------------------------------------------------------
# chunked pipelining: equal to the reference's, and bit-identical to eager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 6, 8])
@pytest.mark.parametrize("chunks", [2, 3, 7])
def test_pipelined_equals_reference_and_eager(n, chunks):
    net, jnet = nets(n)
    x, jx = pair(data((n, 41), np.float32, seed=1))
    for algo in (["rd", "ring"] if n & (n - 1) == 0 else ["ring"]):
        piped = coll.allreduce(net, x, "sum", algorithm=algo,
                               pipeline_chunks=chunks)
        same(piped, coll.allreduce(net, x, "sum", algorithm=algo))
        same(piped, jcoll.allreduce(jnet, jx, "sum", algorithm=algo,
                                    pipeline_chunks=chunks), exact=False)
    y, jy = pair(data((n, 23), np.int32, seed=2))
    same(coll.broadcast(net, y, 3 % n, pipeline_chunks=chunks),
         jcoll.broadcast(jnet, jy, 3 % n, pipeline_chunks=chunks))
    for algo in (None, "ring"):
        same(coll.fcollect(net, y, algorithm=algo, pipeline_chunks=chunks),
             jcoll.fcollect(jnet, jy, algorithm=algo,
                            pipeline_chunks=chunks))
    same(coll.collect(net, y, pipeline_chunks=chunks),
         jcoll.collect(jnet, jy, pipeline_chunks=chunks))
    z, jz = pair(data((n, n * 5), np.int32, seed=3))
    same(coll.alltoall(net, z, pipeline_chunks=chunks),
         jcoll.alltoall(jnet, jz, pipeline_chunks=chunks))


def test_pipelined_zero_size_and_auto():
    net, jnet = nets(4)
    x = torch.zeros((4, 0))
    for fn in (lambda: coll.broadcast(net, x, 0, pipeline_chunks=4),
               lambda: coll.allreduce(net, x, "sum", algorithm="ring",
                                      pipeline_chunks=4),
               lambda: coll.allreduce(net, x, "sum", algorithm="rd",
                                      pipeline_chunks=4),
               lambda: coll.fcollect(net, x, pipeline_chunks=4),
               lambda: coll.collect(net, x, pipeline_chunks=4)):
        assert fn().numel() == 0
    ctx, jctx = sim_ctx(8, epiphany3().__class__((2, 4)), device="cpu"), \
        jsim_ctx(8, JMesh((2, 4)))
    y, jy = pair(data((8, 64), np.int32, seed=5))
    same(ctx.to_all(y, "sum", algorithm="auto", pipeline_chunks="auto"),
         jctx.to_all(jy, "sum", algorithm="auto", pipeline_chunks="auto"))


# ---------------------------------------------------------------------------
# teams, active sets, partitions (hier)
# ---------------------------------------------------------------------------

TEAMS = [(1, 4, 7), (0, 1, 2, 3), (6, 2, 5, 0, 3), (2,), (7, 0)]


@pytest.mark.parametrize("members", TEAMS)
def test_team_collectives(members):
    n = 8
    net, jnet = nets(n)
    t = team_mod.make_team(members, n)
    jt = jteam_of(t)
    x, jx = pair(data((n, 6), np.int32, seed=len(members)))
    xf, jxf = pair(data((n, 6), np.float32, seed=len(members)))
    for op in ("sum", "max"):
        for algo in (None, "ring", "auto") + (
                ("rd",) if t.size & (t.size - 1) == 0 else ()):
            same(coll.allreduce(net, x, op, team=t, algorithm=algo),
                 jcoll.allreduce(jnet, jx, op, team=jt, algorithm=algo))
            same(coll.allreduce(net, xf, op, team=t, algorithm=algo),
                 jcoll.allreduce(jnet, jxf, op, team=jt, algorithm=algo),
                 exact=False)
    same(coll.broadcast(net, x, t.size - 1, team=t),
         jcoll.broadcast(jnet, jx, t.size - 1, team=jt))
    same(coll.fcollect(net, x, team=t), jcoll.fcollect(jnet, jx, team=jt))
    same(coll.collect(net, x, team=t), jcoll.collect(jnet, jx, team=jt))
    a, ja = pair(data((n, 2 * t.size), np.int32, seed=9))
    same(coll.alltoall(net, a, team=t), jcoll.alltoall(jnet, ja, team=jt))
    own, info = coll.reduce_scatter(net, x, team=t)
    jown, jinfo = jcoll.reduce_scatter(jnet, jx, team=jt)
    same(own, jown)
    same(coll.allgather_unpad(net, own, info, team=t),
         jcoll.allgather_unpad(jnet, jown, jinfo, team=jt))
    same(coll.barrier(net, team=t, algorithm="tree"),
         jcoll.barrier(jnet, team=jt, algorithm="tree"))


@pytest.mark.parametrize("shape,axis", [((4, 4), -1), ((4, 4), 0),
                                        ((2, 3), -1), ((3, 3), 0),
                                        ((2, 8), -1)])
def test_hier_allreduce_and_partition_collectives(shape, axis):
    topo = MeshTopology(shape=shape, torus=(False, False))
    n = topo.n_pes
    net, jnet = nets(n)
    part = team_mod.split_2d(team_mod.team_world(n), topo, axis)
    jpart = jteam_of(part)
    x, jx = pair(data((n, 13), np.int32, seed=n))
    xf, jxf = pair(data((n, 13), np.float32, seed=n))
    for cross in (None, "ring"):
        same(coll.allreduce_hier(net, x, "sum", partition=part,
                                 cross_algorithm=cross),
             jcoll.allreduce_hier(jnet, jx, "sum", partition=jpart,
                                  cross_algorithm=cross))
    same(coll.allreduce_hier(net, xf, "max", partition=part),
         jcoll.allreduce_hier(jnet, jxf, "max", partition=jpart))
    same(coll.allreduce_hier(net, xf, "sum", partition=part),
         jcoll.allreduce_hier(jnet, jxf, "sum", partition=jpart),
         exact=False)
    same(coll.allreduce(net, x, "sum", team=part),
         jcoll.allreduce(jnet, jx, "sum", team=jpart))
    same(coll.fcollect(net, x, team=part),
         jcoll.fcollect(jnet, jx, team=jpart))


def test_active_set_and_partition_auto():
    ctx, jctx = sim_ctx(16, epiphany3(), device="cpu"), \
        jsim_ctx(16, jtopo(epiphany3()))
    x, jx = pair(data((16, 40), np.int32, seed=7))
    same(ctx.to_all(x, "sum", PE_start=1, logPE_stride=1, PE_size=4),
         jctx.to_all(jx, "sum", PE_start=1, logPE_stride=1, PE_size=4))
    rows, jrows = ctx.team_split_2d(), jctx.team_split_2d()
    same(ctx.to_all(x, "sum", algorithm="auto", partition=rows),
         jctx.to_all(jx, "sum", algorithm="auto", partition=jrows))
    same(ctx.to_all(x, "sum", algorithm="hier", partition=rows),
         jctx.to_all(jx, "sum", algorithm="hier", partition=jrows))
    with pytest.raises(ValueError):
        ctx.to_all(x, "sum", team=rows.teams[0], partition=rows)


# ---------------------------------------------------------------------------
# mesh-embedded rings, NoC-faithful SIM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo", [epiphany3(), MeshTopology((3, 5), (False,
                                                                    False))],
                         ids=["4x4", "3x5"])
@pytest.mark.parametrize("embedding", ["snake", "auto"])
def test_embedded_collectives(topo, embedding):
    n = topo.n_pes
    ctx = sim_ctx(n, topo, device="cpu", embedding=embedding)
    jctx = jsim_ctx(n, jtopo(topo), embedding=embedding)
    x, jx = pair(data((n, 19), np.int32, seed=n))
    xf, jxf = pair(data((n, 19), np.float32, seed=n))
    for chunks in (None, 3):
        same(ctx.to_all(x, "sum", algorithm="ring_emb",
                        pipeline_chunks=chunks),
             jctx.to_all(jx, "sum", algorithm="ring_emb",
                         pipeline_chunks=chunks))
        same(ctx.fcollect(x, algorithm="ring_emb", pipeline_chunks=chunks),
             jctx.fcollect(jx, algorithm="ring_emb",
                           pipeline_chunks=chunks))
        same(ctx.collect(x, pipeline_chunks=chunks),
             jctx.collect(jx, pipeline_chunks=chunks))
    same(ctx.to_all(xf, "sum"), jctx.to_all(jxf, "sum"), exact=False)
    t = team_mod.make_team(range(1, n, 2), n)
    same(ctx.to_all(x, "sum", team=t), jctx.to_all(jx, "sum",
                                                   team=jteam_of(t)))
    same(ctx.collect(x, team=t), jctx.collect(jx, team=jteam_of(t)))
    same(ctx.fcollect(x, team=t, algorithm="auto"),
         jctx.fcollect(jx, team=jteam_of(t), algorithm="auto"))
    if len(topo.shape) == 2 and topo.shape[0] > 1:
        rows = ctx.team_split_2d()
        same(ctx.to_all(x, "sum", algorithm="hier", partition=rows),
             jctx.to_all(jx, "sum", algorithm="hier",
                         partition=jteam_of(rows)))


@pytest.mark.parametrize("noc", [False, True])
def test_explicit_embedding_order_and_noc(noc):
    topo = epiphany3()
    order = tuple(reversed(topo.snake_order()))
    n = topo.n_pes
    net, jnet = nets(n, noc=noc, topo=topo)
    x, jx = pair(data((n, 11), np.int32, seed=3))
    for algo in ("ring", "rd", "ring_emb"):
        same(coll.allreduce(net, x, "sum", algorithm=algo, topo=topo,
                            embedding=order),
             jcoll.allreduce(jnet, jx, "sum", algorithm=algo,
                             topo=jtopo(topo), embedding=order))
    same(coll.fcollect(net, x, topo=topo, embedding=order),
         jcoll.fcollect(jnet, jx, topo=jtopo(topo), embedding=order))


def test_nocsim_bit_identical_to_sim_and_reference():
    topo = epiphany3()
    n = topo.n_pes
    sim, _ = nets(n)
    noc, jnoc = nets(n, noc=True, topo=topo)
    rng = np.random.RandomState(0)
    from repro_torch.core.pattern import ring_pattern
    from repro.core.pattern import ring_pattern as jring
    payloads = [rng.randn(n, 13).astype(np.float32), rng.rand(n, 7) > 0.5,
                rng.randint(0, 100, (n, 9)).astype(np.int8),
                rng.randint(0, 100, (n, 9)).astype(np.uint8),
                rng.randint(0, 100, (n, 9)).astype(np.int16)]
    for raw in payloads:
        x, jx = pair(raw)
        for off in (1, 5, 8):
            p = ring_pattern(n, off)
            got = noc.ppermute(x, p)
            same(got, sim.ppermute(x, p))
            same(got, jnoc.ppermute(jx, jring(n, off)))
        same(noc.ppermute(x, []), torch.zeros_like(x))


@pytest.mark.parametrize("axis", [0, 1])
def test_dyn_slice_and_update_block(axis):
    n, bs = 5, 3
    net, jnet = nets(n)
    x, jx = pair(data((n, 4, 12), np.int32, seed=axis))
    if axis == 1:
        x, jx = x.transpose(1, 2).contiguous(), jnp.swapaxes(jx, 1, 2)
    idx = np.array([0, 3, 1, 2, 3])
    out = netops.dyn_slice_block(net, x, idx, bs, axis)
    jout = jnetops.dyn_slice_block(jnet, jx, jnp.asarray(idx), bs, axis)
    same(out, jout)
    upd, jupd = pair(-np.asarray(jout))
    same(netops.dyn_update_block(net, x, upd, idx, bs, axis),
         jnetops.dyn_update_block(jnet, jx, jupd, jnp.asarray(idx), bs,
                                  axis))


def test_stage_buffers_die_with_their_last_reference(monkeypatch):
    """Each stage's delivery and combine output is freed as soon as the
    next stage replaces it, without waiting for the cyclic garbage
    collector: the 1 GiB bucket on the card must not hold every stage's
    buffers at once."""
    import gc
    import weakref
    from repro_torch.kernels import put_copy as pc
    from repro_torch.kernels import reduce_combine as rc
    outs = []
    put, comb = pc.put_copy, rc.reduce_combine

    def track(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            outs.append(weakref.ref(out))
            return out
        return run

    monkeypatch.setattr(pc, "put_copy", track(put))
    monkeypatch.setattr(rc, "reduce_combine", track(comb))
    net, _ = nets(8)
    x, _ = pair(data((8, 33), np.float32))
    gc.disable()
    try:
        for algo in ("rd", "ring"):
            outs.clear()
            result = coll.allreduce(net, x, "sum", algorithm=algo)
            alive = [r() for r in outs if r() is not None]
            assert len(outs) > 3 and all(a is result for a in alive), algo
    finally:
        gc.enable()
