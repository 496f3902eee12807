"""Kernels 1-3 of the port (put_copy, dma_copy, reduce_combine) against the
JAX package's kernels on the CPU, on the same numpy inputs, bit for bit.

On the CPU each wrapper runs its kernel's plain version (`kernels/ref.py`);
the reference side runs the Pallas kernels in interpret mode, as
test_kernels.py does.  The batched forms (a source-row table, a batch of
descriptors) are held to the reference's SimNetOps.ppermute and
collectives._take_blocks on the same stacked arrays.  Also here: the
heap's tree packing against `repro.core.heap`."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as jcoll
from repro.core import heap as jheap
from repro.core.netops import NocSimNetOps as JNocSim
from repro.core.netops import SimNetOps as JSim
from repro.core.pattern import compile_pattern as jcompile
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import collectives as coll
from repro_torch.core import heap
from repro_torch.core.netops import NocSimNetOps, SimNetOps
from repro_torch.core.pattern import compile_pattern
from repro_torch.core.topology import epiphany3
from repro_torch.kernels import ops, ref
from repro_torch.kernels import put_copy as pc
from repro_torch.kernels import reduce_combine as rc
from torch_elsewhere import elsewhere as _elsewhere

RNG = np.random.RandomState(0)


def np_of(t):
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def bitwise(port, want):
    a, b = np_of(port), np_of(want)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                      a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# kernel 1: put_copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 128), (37, 300), (8, 128),
                                   (100, 1), (1, 513)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_put_copy_matches_reference_kernel(shape, dtype):
    x = (RNG.randn(*shape) * 10).astype(dtype)
    before = pc.launches
    bitwise(ops.put_copy(torch.from_numpy(x)),
            jops.put_copy(jnp.asarray(x), interpret=True))
    assert pc.launches == before          # the CPU runs the plain version


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int8, np.bool_])
@pytest.mark.parametrize("n,width", [(16, 5), (7, 1), (17, 33)])
def test_put_rows_is_the_sim_delivery(dtype, n, width):
    """put_copy with a pattern's source-row table == the reference's
    SimNetOps.ppermute of the same stacked array."""
    raw = RNG.randn(n, width, 3) * 50
    x = (raw > 0) if dtype == np.bool_ else raw.astype(dtype)
    for pairs in ([(i, (i + 3) % n) for i in range(n)], [(0, n - 1)],
                  [(s, d) for s, d in zip(range(n), reversed(range(n)))]):
        p = compile_pattern(pairs, n)
        got = pc.put_copy(torch.from_numpy(x), p.gather_table_device("cpu"))
        bitwise(got, JSim(n).ppermute(jnp.asarray(x), jcompile(pairs, n)))
    strided = torch.from_numpy(x)[:, 1:]            # rows at a stride
    table = compile_pattern([(1, 0)], n).gather_table_device("cpu")
    bitwise(pc.put_copy(strided, table),
            JSim(n).ppermute(jnp.asarray(x[:, 1:]), jcompile([(1, 0)], n)))


def test_put_rows_table_reaches_rows_beyond_the_source():
    """The stacked-wave table of NocSimNetOps has more output rows than
    source rows; -1 rows are zeros."""
    x = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    rows = torch.tensor([3, -1, 0, 0, -1, 2], dtype=torch.int32)
    want = np.zeros((6, 3), np.int32)
    for i, r in enumerate(rows.tolist()):
        if r >= 0:
            want[i] = x[r].numpy()
    np.testing.assert_array_equal(pc.put_copy(x, rows).numpy(), want)
    np.testing.assert_array_equal(pc.put_copy(x).numpy(), x.numpy())


def test_nocsim_delivery_matches_reference():
    topo = epiphany3()
    x = RNG.randn(16, 11).astype(np.float32)
    for off in (1, 4, 9):
        pairs = [(i, (i + off) % 16) for i in range(16)]
        bitwise(NocSimNetOps(16, "cpu", topo=topo).ppermute(
                    torch.from_numpy(x), pairs),
                JNocSim(16, topo=_jtopo(topo)).ppermute(jnp.asarray(x),
                                                        pairs))


def _jtopo(topo):
    from repro.core.topology import MeshTopology
    return MeshTopology(topo.shape, topo.torus, topo.link_cost)


# ---------------------------------------------------------------------------
# kernel 2: dma_copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_dma_copy_matches_reference_kernel(dtype):
    src = (RNG.randn(64, 256) * 100).astype(dtype)
    dst = (RNG.randn(96, 384) * 100).astype(dtype)
    kw = dict(src_origin=(32, 128), dst_origin=(0, 256), region=(32, 128))
    want = jops.dma_copy(jnp.asarray(src), jnp.asarray(dst), interpret=True,
                         **kw)
    tdst = torch.from_numpy(dst.copy())
    bitwise(ops.dma_copy(torch.from_numpy(src), tdst, **kw), want)
    np.testing.assert_array_equal(tdst.numpy(), dst)    # functional
    # any region, not only (32, 128)-aligned ones
    kw = dict(src_origin=(3, 5), dst_origin=(7, 11), region=(13, 17))
    bitwise(ops.dma_copy(torch.from_numpy(src), torch.from_numpy(dst), **kw),
            jref.dma_copy_ref(jnp.asarray(src), jnp.asarray(dst), **kw))


def test_dma_copy_f64():
    """float64, which the reference runs as float32 without x64."""
    src, dst = RNG.randn(64, 256), RNG.randn(96, 384)
    want = dst.copy()
    want[0:32, 256:384] = src[32:64, 128:256]
    got = ops.dma_copy(torch.from_numpy(src), torch.from_numpy(dst),
                       src_origin=(32, 128), dst_origin=(0, 256),
                       region=(32, 128))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dma_plan_checks_bounds():
    with pytest.raises(ValueError):
        pc.DmaPlan([[0, 0, 0, 0, 5, 5]], (4, 8), (8, 8))     # leaves src
    with pytest.raises(ValueError):
        pc.DmaPlan([[0, 0, 4, 4, 4, 5]], (8, 8), (8, 8))     # leaves dst
    with pytest.raises(ValueError):
        pc.DmaPlan([[0, 0, 0, 0, 0, 5]], (8, 8), (8, 8))     # empty
    plan = pc.DmaPlan([[0, 0, 0, 0, 2, 2]], (8, 8), (8, 8))
    with pytest.raises(ValueError):
        pc.dma_copy(torch.zeros(4, 8), torch.zeros(8, 8), plan)


@pytest.mark.parametrize("n,blocks,axis,shape", [
    (16, 16, 0, (16, 16 * 5)), (5, 5, 0, (5, 35)), (4, 4, 1, (4, 3, 8, 2)),
    (6, 6, 0, (6, 12, 2)), (3, 3, 1, (3, 2, 9))])
def test_dma_take_blocks_matches_reference(n, blocks, axis, shape):
    """One descriptor per (PE, block): the ring collectives' block gather
    equals the reference's _take_blocks on the same stacked array."""
    x = RNG.randint(-1000, 1000, shape).astype(np.int32)
    for idx in ((np.arange(n)[:, None] + np.arange(blocks)) % blocks,
                (np.arange(n)[:, None] - np.arange(blocks)) % blocks,
                RNG.randint(0, blocks, (n, blocks))):
        got = coll._take_blocks(SimNetOps(n, "cpu"), torch.from_numpy(x),
                                idx, blocks, axis)
        want = jcoll._take_blocks(JSim(n), jnp.asarray(x),
                                  jnp.asarray(idx), blocks, axis)
        bitwise(got, want)


# ---------------------------------------------------------------------------
# kernel 3: reduce_combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
@pytest.mark.parametrize("k", [2, 3, 5])
def test_reduce_combine_matches_reference_kernel(op, k):
    bufs = [RNG.rand(40, 200).astype(np.float32) + 0.1 for _ in range(k)]
    got = ops.reduce_combine([torch.from_numpy(b) for b in bufs], op)
    bitwise(got, jops.reduce_combine([jnp.asarray(b) for b in bufs], op,
                                     interpret=True))
    bitwise(got, jref.reduce_combine_ref([jnp.asarray(b) for b in bufs], op))


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
def test_reduce_combine_bf16_and_int_fold_in_storage_type(op):
    """bf16 rounds to storage after every step, as the reference kernel
    does on bf16 refs; int32 sum and prod wrap."""
    bufs = [RNG.randn(16, 77).astype(np.float32) * 3 for _ in range(5)]
    tb = [torch.from_numpy(b).to(torch.bfloat16) for b in bufs]
    jb = [jnp.asarray(b).astype(jnp.bfloat16) for b in bufs]
    bitwise(ops.reduce_combine(tb, op), jref.reduce_combine_ref(jb, op))
    bitwise(ops.reduce_combine(tb, op),
            jops.reduce_combine(jb, op, interpret=True))
    f32 = [t.float() for t in tb]
    acc = ref.reduce_combine_ref(f32, op).to(torch.bfloat16)
    if op in ("sum", "prod"):      # an f32 accumulation rounds differently
        assert not torch.equal(acc, ops.reduce_combine(tb, op))
    ints = [RNG.randint(-2**31, 2**31 - 1, (8, 9)).astype(np.int32)
            for _ in range(3)]
    bitwise(ops.reduce_combine([torch.from_numpy(i) for i in ints], op),
            jref.reduce_combine_ref([jnp.asarray(i) for i in ints], op))


def test_reduce_combine_nan_and_strided_rows():
    a = torch.tensor([[1.0, float("nan"), 3.0, -1.0]])
    b = torch.tensor([[float("nan"), 2.0, 1.0, float("nan")]])
    for op, fn in (("max", jnp.maximum), ("min", jnp.minimum)):
        got = rc.reduce_combine([a, b], op).numpy()
        want = np.asarray(fn(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
        np.testing.assert_array_equal(got, want)       # NaN where NaN
        assert np.isnan(got).sum() == 3
    x = torch.from_numpy(RNG.randn(6, 40).astype(np.float32))
    blocks = [x[:, 10 * t:10 * (t + 1)] for t in range(4)]    # strided
    np.testing.assert_array_equal(
        rc.reduce_combine(blocks, "sum").numpy(),
        np.asarray(jref.reduce_combine_ref(
            [jnp.asarray(b.numpy()) for b in blocks], "sum")))
    with pytest.raises(ValueError):
        rc.reduce_combine([x], "sum")
    with pytest.raises(ValueError):
        rc.reduce_combine([x, x], "xor")
    with pytest.raises(ValueError):
        rc.reduce_combine([x, x[:3]], "sum")


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor that is neither on the CPU nor on CUDA has no kernel and
    no plain-version fallback: on the meta device each wrapper takes its
    meta path (the launch counted, outputs of the kernel's shapes, no
    plain version run), on any other it raises."""
    m = torch.empty((4, 8), device="meta")
    before = (pc.launches, pc.dma_launches, rc.launches)
    plan = pc.DmaPlan([[0, 0, 0, 0, 2, 2]], (4, 8), (4, 8))
    with mock.patch.object(ref, "put_copy_ref", side_effect=AssertionError), \
            mock.patch.object(ref, "dma_copy_ref",
                              side_effect=AssertionError), \
            mock.patch.object(ref, "reduce_combine_ref",
                              side_effect=AssertionError):
        out = [pc.put_copy(m), rc.reduce_combine([m, m], "sum"),
               pc.dma_copy(m, torch.empty((4, 8), device="meta"), plan)]
    assert all(o.device.type == "meta" and o.shape == (4, 8) for o in out)
    assert (pc.launches, pc.dma_launches, rc.launches) == \
        tuple(b + 1 for b in before)
    e = _elsewhere(m)
    with pytest.raises(ValueError, match="no kernel"):
        pc.put_copy(e)
    with pytest.raises(ValueError, match="no kernel"):
        rc.reduce_combine([e, e], "sum")
    with pytest.raises(ValueError, match="no kernel"):
        pc.dma_copy(e, _elsewhere(m), plan)


def test_stage_combines_go_through_the_kernel_wrapper(monkeypatch):
    """Every sum/prod/max/min stage combine of the runtime calls
    reduce_combine with two buffers; and/or/xor stay plain torch."""
    calls = []
    real = rc.reduce_combine

    def spy(bufs, op="sum"):
        calls.append((len(bufs), op))
        return real(bufs, op)

    monkeypatch.setattr(rc, "reduce_combine", spy)
    net = SimNetOps(8, "cpu")
    x = torch.from_numpy(RNG.randint(0, 9, (8, 20)).astype(np.int32))
    coll.allreduce(net, x, "max", algorithm="rd")
    assert calls == [(2, "max")] * 3
    calls.clear()
    coll.allreduce(net, x, "sum", algorithm="ring")
    assert calls == [(2, "sum")] * 7
    calls.clear()
    coll.allreduce(net, x, "xor")
    assert calls == []


# ---------------------------------------------------------------------------
# heap: tree packing on one flat buffer
# ---------------------------------------------------------------------------

def _trees():
    """The same tree twice: torch leaves and jax leaves, one numpy draw."""
    r = np.random.RandomState(7)
    a, b, c, d = (r.randn(3, 7), r.randn(5), r.randn(2, 2, 5), r.randn(130))
    return [lambda m: {"w1": m(a), "b": m(b), "a": [m(c), m(3.0)]},
            lambda m: [m(np.arange(5)), m(np.ones(3)), (m(d),)]]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("align", [128, 8])
def test_pack_unpack_match_reference(which, align):
    import jax
    make = _trees()[which]
    t = make(lambda v: torch.from_numpy(np.asarray(v, np.float32)))
    j = make(lambda v: jnp.asarray(np.asarray(v, np.float32)))
    spec, jspec = heap.plan_pack(t, align_elems=align), \
        jheap.plan_pack(j, align_elems=align)
    assert (spec.shapes, spec.offsets, spec.total) == \
        (jspec.shapes, jspec.offsets, jspec.total)
    buf = heap.pack(t, spec)
    bitwise(buf, jheap.pack(j, jspec))
    out = heap.unpack(buf, spec)
    jout = jheap.unpack(jheap.pack(j, jspec), jspec)
    assert type(out) is type(jout)
    leaves, _ = heap.tree_flatten(out)
    for x, y in zip(leaves, jax.tree.leaves(jout)):
        bitwise(x, y)


def test_pack_mixed_dtypes_keep_leaf_dtypes():
    t = [torch.ones(3, dtype=torch.bfloat16), torch.arange(4,
                                                           dtype=torch.int32)]
    spec = heap.plan_pack(t, dtype=torch.float32)
    out = heap.unpack(heap.pack(t, spec), spec)
    assert out[0].dtype == torch.bfloat16 and out[1].dtype == torch.int32
    np.testing.assert_array_equal(out[1].numpy(), np.arange(4))
    j = [jnp.ones(3, jnp.bfloat16), jnp.arange(4, dtype=jnp.int32)]
    assert str(heap.plan_pack(t).dtype).split(".")[1] == \
        jnp.dtype(jheap.plan_pack(j).dtype).name           # promoted alike
