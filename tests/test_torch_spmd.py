"""The SPMD backend on the CPU: 8 rank processes (gloo barriers, a
shared-memory symmetric heap with small slots, so payloads cross in
chunks) against the reference's shard_map over 8 host devices and the
port's own `sim_ctx(8, device="cpu")`:

  * `test_spmd_equiv.py`'s collectives through `spmd_ctx`: broadcast
    from 3 and 5, fcollect, collect and alltoall bit for bit, to_all sum
    and max (rd and ring) at rtol 1e-5; barrier_all, dissemination and
    the WAND analogue;
  * its 2x4 (data x model) `Comm` checks: allreduce, allgather,
    reduce_scatter and broadcast over `model`, grad_sync over `data`, at
    rtol 1e-5; alltoall over `model` and over the flattened ("data",
    "model"), and its gradient, bit for bit;
  * two back-to-back ppermutes of different patterns with every even
    rank slow to read its slot: right with the two banks, wrong when the
    bank is pinned to one (the case catches a missing second bank);
  * the gradient of an allreduce and of an allgather against jax.grad
    in shard_map;
  * a rank that raises makes the run raise.

The reference runs in a subprocess (XLA_FLAGS=8 host devices) while the
ranks run, and hands its numbers over as .npz."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import sim_ctx, spmd

ROOT = os.path.join(os.path.dirname(__file__), "..")
N = 8
SLOT = 4096

REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core import spmd_ctx
    from repro.parallel.comm import AxisSpec, Comm

    inp = dict(np.load(sys.argv[2]))
    out = {}
    n = 8
    mesh = jax.make_mesh((n,), ("pe",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    x, x2 = jnp.asarray(inp["x"]), jnp.asarray(inp["x2"])

    def one(name, fn, arg):
        def body(xl):
            return fn(spmd_ctx("pe"), xl[0])[None]
        out[name] = np.asarray(jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("pe"),), out_specs=P("pe")))(arg))

    one("broadcast3", lambda c, v: c.broadcast(v, 3), x)
    one("broadcast5", lambda c, v: c.broadcast(v, 5), x)
    one("fcollect", lambda c, v: c.fcollect(v), x)
    one("collect", lambda c, v: c.collect(v), x)
    one("sum", lambda c, v: c.to_all(v, "sum"), x)
    one("max", lambda c, v: c.to_all(v, "max"), x)
    one("ring", lambda c, v: c.to_all(v, "sum", algorithm="ring"), x)
    one("alltoall", lambda c, v: c.alltoall(v), x2)

    mesh2 = jax.make_mesh((2, 4), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    y, w = jnp.asarray(inp["y"]), jnp.asarray(inp["w"])
    z, wz = jnp.asarray(inp["z"]), jnp.asarray(inp["wz"])
    ST = P(("data", "model"))

    def body(v, wl, zl, wzl):
        comm = Comm(AxisSpec(), "shmem")
        a = comm.allreduce(v, "model")
        b = comm.allgather(v, "model", concat_axis=0)
        c = comm.reduce_scatter(b, "model", scatter_axis=0)
        e = comm.broadcast(v, "model", root=2)
        f = comm.grad_sync(v)
        ga = jax.grad(lambda u: jnp.sum(wl * comm.allreduce(u, "model")))(v)
        wg = jnp.concatenate([wl] * 4, 0)
        gb = jax.grad(lambda u: jnp.sum(
            wg * comm.allgather(u, "model", concat_axis=0)))(v)
        a2a = []
        for ax in ("model", ("data", "model")):
            a2a.append(comm.alltoall(zl, ax, split_axis=1, concat_axis=1))
            a2a.append(jax.grad(lambda u: jnp.sum(wzl * comm.alltoall(
                u, ax, split_axis=1, concat_axis=1)))(zl))
        return tuple(t[None] for t in (a, b, c, e, f, ga, gb, *a2a))

    res = jax.jit(jax.shard_map(
        body, mesh=mesh2, in_specs=(ST,) * 4, out_specs=(ST,) * 11,
        check_vma=False))(y, w, z, wz)
    for k, v in zip(("allreduce", "allgather", "reduce_scatter",
                     "broadcast", "grad_sync", "grad_allreduce",
                     "grad_allgather", "alltoall_model",
                     "grad_alltoall_model", "alltoall_data_model",
                     "grad_alltoall_data_model"), res):
        out["comm/" + k] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("REF-OK")
""")


def _inputs():
    return {"x": np.random.RandomState(0).randn(N, 6).astype(np.float32),
            "x2": np.random.RandomState(2).randn(N, N * 2).astype(
                np.float32),
            "y": np.random.RandomState(1).randn(8, 4).astype(np.float32),
            "w": np.random.RandomState(3).randn(8, 4).astype(np.float32),
            "z": np.random.RandomState(4).randn(8, 16).astype(np.float32),
            "wz": np.random.RandomState(5).randn(8, 16).astype(np.float32)}


def _slow_barrier(rt):
    """`rt.barrier` with even ranks sleeping after it: their reads come
    late, after the odd ranks have gone on to the next round."""
    import time
    plain = rt.barrier

    def barrier():
        plain()
        if rt.rank % 2 == 0:
            time.sleep(0.05)
    return barrier


def rank_body(inp):
    """Every check's port side in one 8-rank run."""
    from repro_torch.core import spmd_ctx
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.parallel.comm import AxisSpec, Comm
    rt = spmd.current()
    r = rt.rank
    out = {}
    try:                        # before any mesh: no one-device fallback
        Comm(AxisSpec())
        out["comm_without_mesh"] = "built"
    except RuntimeError as e:
        out["comm_without_mesh"] = str(e)
    make_rank_mesh((N,), ("pe",))
    ctx = spmd_ctx("pe")
    x = torch.from_numpy(inp["x"])[r:r + 1]
    x2 = torch.from_numpy(inp["x2"])[r:r + 1]
    out["broadcast3"] = ctx.broadcast(x, 3)
    out["broadcast5"] = ctx.broadcast(x, 5)
    out["fcollect"] = ctx.fcollect(x)
    out["collect"] = ctx.collect(x)
    out["sum"] = ctx.to_all(x, "sum")
    out["max"] = ctx.to_all(x, "max")
    out["ring"] = ctx.to_all(x, "sum", algorithm="ring")
    out["alltoall"] = ctx.alltoall(x2)
    out["barrier"] = ctx.barrier_all()
    out["all_gather"] = ctx.net.axis_all_gather(x)
    out["wand"] = spmd_ctx("pe", use_wand_barrier=True).barrier_all()

    # two back-to-back ppermutes of different patterns, readers slow
    ring_up = [(p, (p + 1) % N) for p in range(N)]
    ring_down = [(p, (p - 1) % N) for p in range(N)]
    pair = [(p, p ^ 1) for p in range(N)]
    payload = torch.full((1, 300), float(r))          # 1200 B: one chunk
    rt.barrier = _slow_barrier(rt)
    banks = []
    for pin in (False, True):
        if pin:                         # the fault the case must catch
            rt.next_bank = lambda: 0
        got = [ctx.net.ppermute(payload, p)
               for p in (ring_up, ring_down, pair, ring_up)]
        banks.append(torch.cat(got))
    del rt.next_bank, rt.barrier
    out["banks"], out["banks_pinned"] = banks

    make_rank_mesh((2, 4), ("data", "model"))
    comm = Comm(AxisSpec())
    y = torch.from_numpy(inp["y"])[r:r + 1]
    w = torch.from_numpy(inp["w"])[r:r + 1]
    out["comm/allreduce"] = comm.allreduce(y, "model")
    b = comm.allgather(y, "model", concat_axis=0)
    out["comm/allgather"] = b
    out["comm/reduce_scatter"] = comm.reduce_scatter(b, "model",
                                                     scatter_axis=0)
    out["comm/broadcast"] = comm.broadcast(y, "model", root=2)
    out["comm/grad_sync"] = comm.grad_sync(y)
    u = y.clone().requires_grad_()
    (w * comm.allreduce(u, "model")).sum().backward()
    out["comm/grad_allreduce"] = u.grad
    u = y.clone().requires_grad_()
    (torch.cat([w] * 4) * comm.allgather(u, "model", concat_axis=0)
     ).sum().backward()
    out["comm/grad_allgather"] = u.grad
    z = torch.from_numpy(inp["z"])[r:r + 1]
    wz = torch.from_numpy(inp["wz"])[r:r + 1]
    for ax, name in (("model", "model"), (("data", "model"), "data_model")):
        out[f"comm/alltoall_{name}"] = comm.alltoall(z, ax, split_axis=1,
                                                     concat_axis=1)
        u = z.clone().requires_grad_()
        (wz * comm.alltoall(u, ax, split_axis=1, concat_axis=1)
         ).sum().backward()
        out[f"comm/grad_alltoall_{name}"] = u.grad
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(d / "ref.npz"),
         str(d / "inputs.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = spmd.run(rank_body, N, inp, slot_bytes=SLOT, device="cpu")
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "REF-OK" in out, err[-4000:]
    return port, dict(np.load(d / "ref.npz")), inp


def _stacked(port, key):
    return torch.cat([r[key] for r in port]).numpy()


MOVES = ["broadcast3", "broadcast5", "fcollect", "collect", "alltoall"]
REDUCTIONS = ["sum", "max", "ring"]


@pytest.mark.parametrize("name", MOVES + REDUCTIONS)
def test_collective_matches_shard_map_and_sim(runs, name):
    port, ref, inp = runs
    got = _stacked(port, name)
    sim = sim_ctx(N, device="cpu")
    x = torch.from_numpy(inp["x2" if name == "alltoall" else "x"])
    want_sim = {"broadcast3": lambda: sim.broadcast(x, 3),
                "broadcast5": lambda: sim.broadcast(x, 5),
                "fcollect": lambda: sim.fcollect(x),
                "collect": lambda: sim.collect(x),
                "alltoall": lambda: sim.alltoall(x),
                "sum": lambda: sim.to_all(x, "sum"),
                "max": lambda: sim.to_all(x, "max"),
                "ring": lambda: sim.to_all(x, "sum", algorithm="ring"),
                }[name]().numpy()
    if name in MOVES:
        np.testing.assert_array_equal(got, ref[name])
        np.testing.assert_array_equal(got, want_sim)
    else:
        np.testing.assert_allclose(got, ref[name], rtol=1e-5)
        np.testing.assert_allclose(got, want_sim, rtol=1e-5)


@pytest.mark.parametrize("name", ["allreduce", "allgather",
                                  "reduce_scatter", "broadcast",
                                  "grad_sync"])
def test_comm_2x4_matches_shard_map(runs, name):
    port, ref, _ = runs
    got = _stacked(port, "comm/" + name)
    want = ref["comm/" + name].reshape(got.shape)
    if name in ("allgather", "broadcast"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_barrier_all_dissemination_and_wand(runs):
    """The dissemination barrier's tokens equal sim_ctx's; the WAND
    analogue (a zero-token axis_psum over the group) returns zeros;
    `SpmdNetOps.axis_all_gather` is the fcollect."""
    port, _, _ = runs
    sim = sim_ctx(N, device="cpu")
    want = sim.barrier_all()
    assert torch.equal(torch.cat([r["barrier"] for r in port]), want)
    assert torch.equal(torch.cat([r["all_gather"] for r in port]),
                       sim.fcollect(torch.from_numpy(runs[2]["x"])))
    for r in port:
        assert torch.equal(r["wand"], torch.zeros(1, dtype=torch.int32))


def test_comm_in_a_rank_needs_the_rank_mesh(runs):
    """A Comm made in a rank before its mesh raises: it would otherwise
    act as one device (axis sizes 1, allreduce the identity) and train
    without any tensor- or data-parallel sync."""
    port, _, _ = runs
    assert all("no rank mesh" in r["comm_without_mesh"] for r in port)


@pytest.mark.parametrize("axis", ["model", "data_model"])
def test_comm_alltoall_over_pes_matches_shard_map(runs, axis):
    """Comm.alltoall over `model` (4 PEs) and over the flattened
    ("data", "model") (8 PEs), and its gradient (the inverse exchange),
    bit for bit against shard_map."""
    port, ref, _ = runs
    for name in (f"alltoall_{axis}", f"grad_alltoall_{axis}"):
        got = _stacked(port, "comm/" + name)
        np.testing.assert_array_equal(
            got, ref["comm/" + name].reshape(got.shape), err_msg=name)


@pytest.mark.parametrize("name", ["grad_allreduce", "grad_allgather"])
def test_gradient_through_collective_matches_jax_grad(runs, name):
    port, ref, _ = runs
    got = _stacked(port, "comm/" + name)
    np.testing.assert_allclose(got, ref["comm/" + name].reshape(got.shape),
                               rtol=1e-5, atol=1e-6)


def test_back_to_back_ppermutes_need_the_second_bank(runs):
    """Each rank's four receipts: from its ring predecessor, its ring
    successor, its pair partner, its predecessor again — exact with two
    banks; with the bank pinned, a slow reader reads the next round's
    store instead."""
    port, _, _ = runs
    for r, res in enumerate(port):
        want = torch.tensor([(r - 1) % N, (r + 1) % N, r ^ 1, (r - 1) % N],
                            dtype=torch.float32)[:, None].expand(4, 300)
        assert torch.equal(res["banks"], want), r
    assert any(not torch.equal(res["banks_pinned"], res["banks"])
               for res in port)


def raising_body(bad_rank):
    if spmd.current().rank == bad_rank:
        raise ValueError("rank fault")
    spmd.current().barrier()             # the others wait for it
    return 0


def test_a_rank_that_raises_makes_the_run_raise():
    with pytest.raises(Exception, match="rank fault"):
        spmd.run(raising_body, 2, 1, slot_bytes=64, device="cpu")


def test_heap_and_runtime_entry_rules():
    h = spmd.SymmetricHeap.allocate(3, 128, device="cpu")
    assert tuple(h.buf.shape) == (3, 2, 128) and h.buf.is_shared()
    assert h.slot(2, 1).shape == (128,)
    assert spmd.SymmetricHeap.allocate(2, device="cpu").slot_bytes == \
        spmd.CPU_SLOT_BYTES
    with pytest.raises(RuntimeError, match="rank process"):
        spmd.current()
    from repro_torch.train import step as tstep
    assert spmd.SLOT_BYTES == tstep.BUCKET_BYTES


def _children():
    """Pids of this process's children (alive or not yet reaped)."""
    me, out = os.getpid(), set()
    for stat in os.listdir("/proc"):
        if not stat.isdigit():
            continue
        try:
            with open(f"/proc/{stat}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError):
            continue
        if ppid == me:
            out.add(int(stat))
    return out


@pytest.mark.parametrize("bad_rank", [-1, 1], ids=["ok", "raising"])
def test_a_run_leaves_no_process_behind(bad_rank):
    """`run` joins its ranks and stops the resource tracker that starting
    them launched: no child it started is alive after it returns."""
    before = _children()
    if bad_rank < 0:
        assert spmd.run(raising_body, 2, bad_rank, slot_bytes=64,
                        device="cpu") == [0, 0]
    else:
        with pytest.raises(Exception, match="rank fault"):
            spmd.run(raising_body, 2, bad_rank, slot_bytes=64, device="cpu")
    assert _children() <= before
