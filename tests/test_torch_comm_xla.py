"""The library-collective backend, `Comm(backend="xla")`, on the CPU:
rank processes whose collectives are torch.distributed calls over gloo
groups of the mesh's axes (`parallel/libcoll.py`), against the
reference's `Comm(AxisSpec(), "xla")` under shard_map on host devices
(`tests/test_spmd_equiv.py`'s setup), and against the port's shmem
backend:

  * on 2x4 (data x model): allreduce sum, max, min (f32, and int64
    against the reference's int32), allgather and reduce_scatter along
    two axes, alltoall with split_axis == concat_axis and !=, broadcast,
    grad_sync; each sum collective's gradient against jax.grad; a tuple
    axis ("model", "data") whose PE order is not ascending world rank
    (the group-order trap), for allreduce, allgather, reduce_scatter and
    alltoall; no heap round in any of them;
  * on pod 2 x data 2 x model 2: grad_sync and grad_sync_bucketed (one
    allreduce over pod x data, then the mean);
  * qwen2's smoke train step on 2x2: loss and every synced gradient
    leaf against the reference's `build_train_step(cfg, axes, "xla")`
    side and against the port's shmem step; steps at grad_rs False, True
    and "fused" (the per-bucket sync: bit for bit the default step);
    no new process group made by a second step;
  * attention="ring" on a data axis of 2 under xla: each shard attends
    locally, as the reference's;
  * granite's smoke MoE layer on 1x4: output, aux and input gradient,
    picks exactly, against the reference and the shmem layer;
  * `ServeEngine(backend="xla")` on 1x4: the shmem engine's tokens;
  * the train launcher at --comm xla --data 2 --model 2 against the
    reference launcher's losses, and the serve launcher at --comm xla
    --model 2 through the dense-cache loop with the reference's tokens.

Movement is compared bit for bit, float reductions at rtol 1e-4 / atol
1e-5.  The reference runs in subprocesses (8 host devices) while the
port's ranks run, and hands its numbers over as .npz."""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import spmd
from repro_torch.launch import build
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import convert, transformer

ROOT = os.path.join(os.path.dirname(__file__), "..")
QWEN, GRANITE = "qwen2-0.5b", "granite-moe-3b-a800m"
TOL = dict(rtol=1e-4, atol=1e-5)
SLOT = 1 << 16                    # heap slot bytes (the shmem side)
OVERRIDE = {"n_heads": 6, "n_kv_heads": 2}      # the 1x4 engine's heads
ENGINE_KW = dict(max_slots=3, page_size=8, max_seq=32, prompt_bucket=16)
NEW = 4                           # new tokens a request
TRAIN_ARGV = ["--arch", QWEN, "--smoke", "--seq-len", "16", "--batch", "4",
              "--steps", "3", "--data", "2", "--model", "2", "--comm",
              "xla"]
SERVE_ARGV = ["--arch", QWEN, "--smoke", "--model", "2", "--comm", "xla",
              "--batch", "2", "--prompt-len", "5", "--tokens", "4",
              "--cache-len", "16"]
# the collectives' outputs, stacked per device over the mesh's ranks
MOVES = ["ag0", "ag1", "a2a_same", "a2a_diff", "bc", "ag_md", "a2a_md",
         "ar_min_int"]
SUMS = ["ar_sum", "ar_max", "ar_min", "rs0", "rs1", "gs", "rs_md", "ar_md"]
GRADS = ["g_ar", "g_ag", "g_rs", "g_a2a", "g_bc", "g_ag_md", "g_a2a_md"]
POD = ["pod_gs", "pod_gsb0", "pod_gsb1"]

REF_SCRIPT = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import smoke_config
    from repro.launch import build
    from repro.launch.mesh import make_mesh
    from repro.models import layers as L
    from repro.models import transformer
    from repro.parallel import sharding
    from repro.parallel.comm import AxisSpec, Comm
    from repro.train import optimizer as opt
    from repro.train import step as tstep

    out = {}
    inputs = dict(np.load(sys.argv[2]))

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                flat(tree[k], prefix + "/" + k)
        else:
            out[prefix] = np.asarray(tree)

    def unflat(prefix):
        tree = {}
        for k, v in inputs.items():
            if k.startswith(prefix + "/"):
                node = tree
                parts = k[len(prefix) + 1:].split("/")
                for q in parts[:-1]:
                    node = node.setdefault(q, {})
                node[parts[-1]] = v
        return tree

    def put(mesh, tree, specs):
        return jax.tree.map(lambda a, s: jax.device_put(
            jnp.asarray(a), NamedSharding(mesh, s)), tree, specs)

    # (a) the collectives on 2x4
    mesh = make_mesh(2, 4)
    ST = P(("data", "model"))
    x, x2 = jnp.asarray(inputs["x"]), jnp.asarray(inputs["x2"])
    xi = jnp.asarray(inputs["xi"]).astype(jnp.int32)

    def coll(v, v2, vi):
        c = Comm(AxisSpec(), "xla")
        md = ("model", "data")
        res = dict(
            ar_sum=c.allreduce(v, "model"),
            ar_max=c.allreduce(v, "model", "max"),
            ar_min=c.allreduce(v, "model", "min"),
            ar_min_int=c.allreduce(vi, "model", "min"),
            ag0=c.allgather(v, "model", concat_axis=0),
            ag1=c.allgather(v, "model", concat_axis=1),
            rs0=c.reduce_scatter(v, "model", scatter_axis=0),
            rs1=c.reduce_scatter(v, "model", scatter_axis=1),
            a2a_same=c.alltoall(v, "model", split_axis=1, concat_axis=1),
            a2a_diff=c.alltoall(v, "model", split_axis=0, concat_axis=1),
            bc=c.broadcast(v, "model", root=2),
            gs=c.grad_sync(v),
            ag_md=c.allgather(v, md, concat_axis=0),
            a2a_md=c.alltoall(v2, md, split_axis=1, concat_axis=0),
            rs_md=c.reduce_scatter(v2, md, scatter_axis=1),
            ar_md=c.allreduce(v, md))
        fs = dict(
            g_ar=lambda u: c.allreduce(u, "model"),
            g_ag=lambda u: c.allgather(u, "model", concat_axis=1),
            g_rs=lambda u: c.reduce_scatter(u, "model", scatter_axis=1),
            g_a2a=lambda u: c.alltoall(u, "model", split_axis=0,
                                       concat_axis=1),
            g_bc=lambda u: c.broadcast(u, "model", root=2),
            g_ag_md=lambda u: c.allgather(u, md, concat_axis=0))
        for k, f in fs.items():
            res[k] = jax.grad(lambda u: jnp.sum(jnp.sin(f(u))))(v)
        res["g_a2a_md"] = jax.grad(lambda u: jnp.sum(jnp.sin(c.alltoall(
            u, md, split_axis=1, concat_axis=0))))(v2)
        return {k: t[None] for k, t in res.items()}

    got = jax.jit(build.shard_mapped(
        coll, mesh, (ST, ST, ST), {k: ST for k in KEYS}))(x, x2, xi)
    for k, v in got.items():
        out["coll/" + k] = np.asarray(v)

    # (b) the gradient syncs with a pod axis: pod 2 x data 2 x model 2
    mesh3 = make_mesh(2, 2, pod=2)
    ST3 = P(("pod", "data", "model"))

    def pod(v, v2):
        c = Comm(AxisSpec(pod="pod"), "xla")
        b = c.grad_sync_bucketed([v, v2])
        return {"pod_gs": c.grad_sync(v)[None], "pod_gsb0": b[0][None],
                "pod_gsb1": b[1][None]}

    got = jax.jit(build.shard_mapped(
        pod, mesh3, (ST3, ST3), {k: ST3 for k in
                                 ("pod_gs", "pod_gsb0", "pod_gsb1")}))(
        x, x2)
    for k, v in got.items():
        out["coll/" + k] = np.asarray(v)

    # (c) qwen2's smoke train step on 2x2 under xla
    cfg = smoke_config(QWEN, dtype=jnp.float32, moment_dtype="f32")
    mesh = make_mesh(2, 2)
    STACK = P(("data", "model"))
    with jax.set_mesh(mesh):
        shapes, specs = build.abstract_params(cfg, mesh)
        params = put(mesh, unflat("train/params"), specs)
        batch = unflat("train/batch")
        bspec = {k: P("data", None) for k in batch}
        axes = AxisSpec()
        stacked = jax.tree.map(lambda _: STACK, specs)

        def grad_fn(p, bt):
            comm = Comm(axes, "xla")
            l, g = jax.value_and_grad(lambda q: transformer.train_loss(
                comm, cfg, q, bt))(p)
            l = comm.allreduce(l, "data") / comm.axis_size("data")
            g = tstep.fused_grad_sync(
                comm, g, sharding.needs_data_sync(cfg, shapes))
            return l, jax.tree.map(lambda t: t[None], g)

        def step_fn(rs):
            def f(p, bt):
                st = tstep.build_train_step(cfg, axes, "xla", grad_rs=rs)
                loss, new, _ = st(p, opt.init_state(p, opt.AdamWConfig()),
                                  bt)
                return loss, jax.tree.map(lambda t: t[None], new)
            return f

        run = lambda fn: jax.jit(build.shard_mapped(
            fn, mesh, (specs, bspec), (P(), stacked)))(params, batch)
        loss, grads = run(grad_fn)
        out["train/loss"] = np.asarray(loss)
        flat(grads, "train/grads")
        for rs in (False, "fused"):
            loss, new = run(step_fn(rs))
            out[f"train/step_{rs}/loss"] = np.asarray(loss)
            flat(new, f"train/step_{rs}/params")

    # (d) attention="ring" on a data axis of 2 under xla: shards attend
    # locally
    ring = dataclasses.replace(cfg, attention="ring")
    attn = jax.tree.map(lambda a: jnp.asarray(a)[0],
                        unflat("ring/params")["layers"]["attn"])
    xr = jnp.asarray(inputs["ring/x"])
    pos = jnp.broadcast_to(jnp.arange(xr.shape[1], dtype=jnp.int32),
                           xr.shape[:2])
    mesh = make_mesh(2, 1)
    with jax.set_mesh(mesh):
        out["ring/xla"] = np.asarray(jax.jit(build.shard_mapped(
            lambda p, x, pos: L.attention(Comm(AxisSpec(), "xla"), ring,
                                          p, x, pos),
            mesh, (P(), P(None, "data"), P(None, "data")),
            P(None, "data")))(attn, xr, pos))

    # (e) granite's smoke MoE layer on 1x4 under xla
    gcfg = smoke_config(GRANITE, dtype=jnp.float32, moment_dtype="f32")
    mesh = make_mesh(1, 4)
    with jax.set_mesh(mesh):
        _, gspecs = build.abstract_params(gcfg, mesh)
        mspecs = jax.tree.map(lambda s: P(*tuple(s)[1:]),
                              gspecs["layers"]["moe"])
        mp = put(mesh, jax.tree.map(lambda a: a[0], unflat(
            "moe/params")["layers"]["moe"]), mspecs)
        xm, wm = (jnp.asarray(inputs[f"moe/{k}"]) for k in "xw")

        def moe_fn(p, x, w):
            comm = Comm(AxisSpec(), "xla")

            def f(xx):
                o, aux = L.moe(comm, gcfg, p, xx)
                return jnp.sum(w * o) + aux, (o, aux)
            (_, (o, aux)), gx = jax.value_and_grad(f, has_aux=True)(x)
            tp = comm.axis_size("model")
            flat_x = x.reshape(-1, x.shape[-1])
            t_local = flat_x.shape[0] // tp
            xs = lax.dynamic_slice_in_dim(
                flat_x, comm.axis_index("model") * t_local, t_local, 0)
            gates = jax.nn.softmax(
                L._dense(xs, p["router"]).astype(jnp.float32), -1)
            _, tope = lax.top_k(gates, gcfg.moe.top_k)
            return o[None], aux[None], gx[None], tope[None]

        res = jax.jit(build.shard_mapped(
            moe_fn, mesh, (mspecs, P(), P()), (STACK,) * 4))(mp, xm, wm)
        for k, v in zip(("out", "aux", "gx", "tope"), res):
            out["moe/" + k] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("REF-OK")
""")

LAUNCH_REF = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    import repro.configs as rconfigs
    from repro.launch import build
    from repro.launch import serve as serve_mod
    from repro.launch import train as train_mod
    from repro.launch.mesh import make_mesh
    out = {}

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                flat(tree[k], prefix + "/" + k)
        else:
            out[prefix] = np.asarray(tree)

    def init(cfg, dims):          # a launcher's own seed-0 init
        mesh = make_mesh(*dims)
        with jax.set_mesh(mesh):
            init_fn, _, _ = build.make_init_fn(cfg, mesh)
            return jax.jit(init_fn)(jax.random.key(0))

    flat(init(rconfigs.smoke_config(QWEN), (2, 2)), "train/params")
    out["train/losses"] = np.asarray(train_mod.main(TRAIN_ARGV))
    orig = rconfigs.smoke_config
    rconfigs.smoke_config = lambda a, **kw: orig(a, dtype=jnp.float32, **kw)
    cfg = dataclasses.replace(rconfigs.smoke_config(QWEN), fsdp=False)
    flat(init(cfg, (1, 2)), "serve/params")
    out["serve/tokens"] = np.asarray(serve_mod.main(SERVE_ARGV))
    np.savez(sys.argv[1], **out)
    print("LAUNCH-OK")
""")


def _cfg(arch, **ov):
    return smoke_config(arch, dtype=torch.float32, moment_dtype="f32", **ov)


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], prefix + "/" + k, out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflat(arrs, prefix):
    """The nested dict of every key under `prefix` (the reference's
    layout)."""
    tree = {}
    for k, v in arrs.items():
        if not k.startswith(prefix + "/"):
            continue
        node = tree
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _global_params(cfg, dims, seed):
    """Global parameters of a `dims` mesh in the port's layout: the
    port's own 1x1 init fitted to the mesh, every vector moved off its
    init by 0.1 x N(0, 1)."""
    gp = convert.fit_global(transformer.init_params(cfg, seed=seed,
                                                    device="cpu"),
                            cfg, tp=dims[1], dp=dims[0])
    gen = torch.Generator().manual_seed(seed)
    return transformer.map_params(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=gen)
        if t.dim() == 1 else t, gp)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    cfg, gcfg = _cfg(QWEN), _cfg(GRANITE)
    return {
        "x": rng.standard_normal((32, 8)).astype(np.float32),
        "x2": rng.standard_normal((32, 16)).astype(np.float32),
        "xi": rng.integers(-50, 50, (32, 8)).astype(np.int64),
        "train/params": _global_params(cfg, (2, 2), 21),
        "train/batch": {k: rng.integers(1, cfg.vocab, (4, 16)).astype(
            np.int32) for k in ("tokens", "targets")},
        "ring/x": rng.standard_normal((2, 6, cfg.d_model)).astype(
            np.float32),
        "moe/params": _global_params(gcfg, (1, 4), 22),
        "moe/x": rng.standard_normal((2, 16, gcfg.d_model)).astype(
            np.float32),
        "moe/w": rng.standard_normal((2, 16, gcfg.d_model)).astype(
            np.float32),
        "engine/params": _global_params(_cfg(QWEN, **OVERRIDE), (1, 4),
                                        23),
        "prompts": [rng.integers(1, 128, size=n).astype(np.int32)
                    for n in (5, 9, 3)],
    }


@pytest.fixture(scope="module")
def ref_run(inputs, tmp_path_factory):
    """The reference's two subprocesses (the shard_map cases, the
    launchers), left to run while the port's ranks run."""
    d = tmp_path_factory.mktemp("comm_xla")
    arrs = {k: inputs[k] for k in ("x", "x2", "xi", "moe/x", "moe/w",
                                   "ring/x")}
    _flat(convert.params_to_jax(inputs["train/params"], _cfg(QWEN)),
          "train/params", arrs)
    _flat(inputs["train/batch"], "train/batch", arrs)
    _flat(convert.params_to_jax(transformer.init_params(
        _cfg(QWEN), seed=24, device="cpu"), _cfg(QWEN)), "ring/params",
        arrs)
    _flat(convert.params_to_jax(inputs["moe/params"], _cfg(GRANITE)),
          "moe/params", arrs)
    np.savez(d / "inputs.npz", **arrs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    script = (f"QWEN = {QWEN!r}\nGRANITE = {GRANITE!r}\n"
              f"KEYS = {MOVES + SUMS + GRADS!r}\n" + REF_SCRIPT)
    launch = (f"QWEN = {QWEN!r}\nTRAIN_ARGV = {TRAIN_ARGV!r}\n"
              f"SERVE_ARGV = {SERVE_ARGV!r}\n" + LAUNCH_REF)
    procs = [subprocess.Popen(
        [sys.executable, "-c", s, str(d / name), str(d / "inputs.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s, name in ((script, "ref.npz"), (launch, "launch.npz"))]
    yield procs, d
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _wait(proc, d, name, ok):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0 and ok in out, err[-4000:]
    return dict(np.load(d / name))


@pytest.fixture(scope="module")
def ref(ref_run, port8, port4):
    (proc, _), d = ref_run
    return _wait(proc, d, "ref.npz", "REF-OK")


@pytest.fixture(scope="module")
def launch_ref(ref_run, port8, port4):
    (_, proc), d = ref_run
    return _wait(proc, d, "launch.npz", "LAUNCH-OK")


# ---------------------------------------------------------------------------
# the port's rank processes
# ---------------------------------------------------------------------------

def rank_body(tasks):
    """One rank: each (key, name, args) of `tasks` through
    `_task_<name>`, in order; their results by key."""
    return {key: globals()[f"_task_{name}"](*args)
            for key, name, args in tasks}


def _task_coll(inp):
    """The 2x4 collectives and gradients, then the pod syncs, under xla;
    the heap rounds and library calls they took."""
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.parallel.comm import AxisSpec, Comm
    rt = spmd.current()
    r = rt.rank
    v, v2 = (torch.as_tensor(inp[k][4 * r:4 * r + 4]) for k in ("x", "x2"))
    vi = torch.as_tensor(inp["xi"][4 * r:4 * r + 4])
    make_rank_mesh((2, 4), ("data", "model"))
    c = Comm(AxisSpec(), "xla")
    md = ("model", "data")
    rounds, calls = rt.rounds, rt.lib_calls
    res = dict(
        ar_sum=c.allreduce(v, "model"),
        ar_max=c.allreduce(v, "model", "max"),
        ar_min=c.allreduce(v, "model", "min"),
        ar_min_int=c.allreduce(vi, "model", "min"),
        ag0=c.allgather(v, "model", concat_axis=0),
        ag1=c.allgather(v, "model", concat_axis=1),
        rs0=c.reduce_scatter(v, "model", scatter_axis=0),
        rs1=c.reduce_scatter(v, "model", scatter_axis=1),
        a2a_same=c.alltoall(v, "model", split_axis=1, concat_axis=1),
        a2a_diff=c.alltoall(v, "model", split_axis=0, concat_axis=1),
        bc=c.broadcast(v, "model", root=2),
        gs=c.grad_sync(v),
        ag_md=c.allgather(v, md, concat_axis=0),
        a2a_md=c.alltoall(v2, md, split_axis=1, concat_axis=0),
        rs_md=c.reduce_scatter(v2, md, scatter_axis=1),
        ar_md=c.allreduce(v, md))
    fs = dict(
        g_ar=(v, lambda u: c.allreduce(u, "model")),
        g_ag=(v, lambda u: c.allgather(u, "model", concat_axis=1)),
        g_rs=(v, lambda u: c.reduce_scatter(u, "model", scatter_axis=1)),
        g_a2a=(v, lambda u: c.alltoall(u, "model", split_axis=0,
                                       concat_axis=1)),
        g_bc=(v, lambda u: c.broadcast(u, "model", root=2)),
        g_ag_md=(v, lambda u: c.allgather(u, md, concat_axis=0)),
        g_a2a_md=(v2, lambda u: c.alltoall(u, md, split_axis=1,
                                           concat_axis=0)))
    for k, (x0, f) in fs.items():
        u = x0.clone().requires_grad_()
        torch.sin(f(u)).sum().backward()
        res[k] = u.grad
    make_rank_mesh((2, 2, 2), ("pod", "data", "model"))
    c = Comm(AxisSpec(pod="pod"), "xla")
    res["pod_gs"] = c.grad_sync(v)
    res["pod_gsb0"], res["pod_gsb1"] = c.grad_sync_bucketed([v, v2])
    res["rounds"] = rt.rounds - rounds
    res["calls"] = rt.lib_calls - calls
    return res


def _count_new_groups():
    """Count torch.distributed.new_group calls in this rank from here
    on: the returned list's length."""
    import torch.distributed as dist
    made = []
    real = dist.new_group

    def counting(*a, **kw):
        made.append(a)
        return real(*a, **kw)
    dist.new_group = counting
    return made


def _task_train(params, batch):
    """qwen2's smoke train step on 2x2 under xla (and shmem): the loss
    and the synced gradients; a step at each grad_rs; the heap rounds
    and the process groups the xla steps made."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding
    from repro_torch.parallel.comm import AxisSpec, Comm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as tstep
    rt = spmd.current()
    cfg = _cfg(QWEN)
    mesh = make_mesh(2, 2)
    local = {k: torch.as_tensor(v).long()
             for k, v in build.local_batch(cfg, batch, mesh).items()}
    out = {}
    made = _count_new_groups()
    bucketed = []
    real = Comm.grad_sync_bucketed

    def spy(self, *a, **kw):
        bucketed.append(self.backend)
        return real(self, *a, **kw)
    groups = []
    with mock.patch.object(Comm, "grad_sync_bucketed", spy):
        for rs in (False, True, "fused"):
            step, _, ocfg = build.make_train_step(cfg, mesh, "xla",
                                                  grad_rs=rs)
            rounds = rt.rounds
            l, new, _ = step(params, opt.init_state(params, ocfg), batch)
            out[f"step_{rs}"] = (float(l), new, rt.rounds - rounds)
            groups.append(len(made))
    out["groups"] = groups
    out["bucketed"] = bucketed
    for backend in ("xla", "shmem"):
        comm = Comm(AxisSpec(), backend)
        rounds = rt.rounds
        loss, grads = tstep.loss_and_grads(comm, cfg, params, local)
        loss = comm.allreduce(loss, "data") / comm.axis_size("data")
        grads = tstep.fused_grad_sync(comm, grads,
                                      sharding.needs_data_sync(cfg, grads))
        out[backend] = {"loss": float(loss), "grads": grads,
                        "rounds": rt.rounds - rounds}
    return out


def _task_ring(seed, x):
    """attention="ring" on a (rep 2, data 2, model 1) mesh under xla and
    shmem: this rank's rows of x (sharded by sequence, at their global
    positions) through the layer."""
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel.comm import AxisSpec, Comm
    cfg = dataclasses.replace(_cfg(QWEN), attention="ring")
    x = torch.as_tensor(x)
    B, Lg = x.shape[:2]
    pos = torch.arange(Lg).expand(B, Lg)
    mesh = make_rank_mesh((2, 2, 1), ("rep", "data", "model"))
    ls, d = Lg // 2, mesh.axis_index("data")
    rows = slice(d * ls, (d + 1) * ls)
    p = transformer.init_params(cfg, seed=seed, device="cpu")
    with torch.no_grad():
        return {b: L.attention(Comm(AxisSpec(), b), cfg,
                               p["layers"][0]["attn"], x[:, rows],
                               pos[:, rows]) for b in ("xla", "shmem")}


def _task_moe(params, x, w):
    """Granite's smoke MoE layer on 1x4 under xla and shmem: output, aux,
    the input's gradient and this rank's top-k picks."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel.comm import AxisSpec, Comm
    cfg = _cfg(GRANITE)
    make_mesh(1, 4)
    p = params["layers"][0]["moe"]
    out = {}
    for backend in ("xla", "shmem"):
        comm = Comm(AxisSpec(), backend)
        xx = torch.as_tensor(x).requires_grad_()
        o, aux = L.moe(comm, cfg, p, xx)
        (torch.as_tensor(w) * o).sum().add(aux).backward()
        _, _, tope, _, _, _ = L.moe_route(cfg, p, L.moe_tokens(
            comm, xx.detach()))
        out[backend] = {"out": o.detach(), "aux": aux.detach(),
                        "gx": xx.grad, "tope": tope}
    return out


def _task_engine(params, prompts):
    """The paged engine on 1x4 with backend xla and shmem: tokens and
    captured logits; the xla engine's heap rounds and library calls."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import ServeEngine
    rt = spmd.current()
    cfg = _cfg(QWEN, **OVERRIDE)
    mesh = make_mesh(1, 4)
    out = {}
    for backend in ("xla", "shmem"):
        rounds, calls = rt.rounds, rt.lib_calls
        eng = ServeEngine(cfg, mesh, params=params, capture_logits=True,
                          backend=backend, **ENGINE_KW)
        rids = [eng.submit(p, NEW) for p in prompts]
        eng.run()
        out[backend] = dict(
            tokens=[eng.results[r] for r in rids],
            logits=[np.stack(eng.logits_trace[r]) for r in rids],
            backend=eng.comm.backend, rounds=rt.rounds - rounds,
            calls=rt.lib_calls - calls)
    return out


@pytest.fixture(scope="module")
def port8(inputs, ref_run):
    """Every rank's collectives: one spawn of 8 CPU ranks."""
    inp = {k: inputs[k] for k in ("x", "x2", "xi")}
    return [r["coll"] for r in spmd.run(
        rank_body, 8, [("coll", "coll", (inp,))], slot_bytes=SLOT,
        device="cpu")]


@pytest.fixture(scope="module")
def port4(inputs, ref_run):
    """Every rank's model cases: one spawn of 4 CPU ranks, each task on
    a mesh of its own."""
    args = []
    for r in range(4):
        tasks = [("ring", "ring", (24, inputs["ring/x"]))]
        cfg = _cfg(QWEN)
        tasks.append(("train", "train", (convert.local_shards(
            inputs["train/params"], cfg, RankMesh(("data", "model"),
                                                  (2, 2), r)),
            inputs["train/batch"])))
        gcfg = _cfg(GRANITE)
        tasks.append(("moe", "moe", (convert.local_shards(
            inputs["moe/params"], gcfg, RankMesh(("data", "model"), (1, 4),
                                                 r)),
            inputs["moe/x"], inputs["moe/w"])))
        ecfg = _cfg(QWEN, **OVERRIDE)
        tasks.append(("engine", "engine", (convert.local_shards(
            inputs["engine/params"], ecfg, RankMesh(("data", "model"),
                                                    (1, 4), r)),
            inputs["prompts"])))
        args.append((tasks,))
    return build.shard_mapped(rank_body, (2, 2), args, device="cpu",
                              slot_bytes=SLOT)


def _stacked(port, key):
    return np.stack([np.asarray(r[key]) for r in port])


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MOVES)
def test_data_movement_matches_reference_bit_for_bit(ref, port8, name):
    """allgather (two axes), alltoall (split == concat and !=), the
    broadcast emulation, the ("model", "data") gather and exchange (PE
    order is not world-rank order) and the int min: bit for bit."""
    got = _stacked(port8, name)
    want = ref["coll/" + name].reshape(got.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", SUMS + POD)
def test_reductions_match_reference(ref, port8, name):
    """allreduce sum/max/min, reduce_scatter (two axes, and over the
    tuple axis), grad_sync, and the pod syncs (one allreduce over pod x
    data, then the mean)."""
    got = _stacked(port8, name)
    np.testing.assert_allclose(got, ref["coll/" + name].reshape(got.shape),
                               **TOL)


@pytest.mark.parametrize("name", GRADS)
def test_gradients_match_jax_grad(ref, port8, name):
    """Each sum collective's gradient (psum, all_gather <-> psum_scatter,
    all_to_all <-> its inverse, the broadcast's mask and psum) against
    jax.grad through the reference under shard_map."""
    got = _stacked(port8, name)
    np.testing.assert_allclose(got, ref["coll/" + name].reshape(got.shape),
                               **TOL)


def test_library_collectives_take_no_heap_round(port8):
    """Under xla the collectives and their gradients cross gloo alone:
    no heap round, one library call each at least."""
    for r in port8:
        assert r["rounds"] == 0
        assert r["calls"] >= len(SUMS + MOVES + GRADS)


def test_axis_group_maps_group_ranks_to_pe_ids():
    """The group-order trap: ("model", "data") of a 2x4 mesh lists world
    ranks 0, 4, 1, 5, ... in PE order; torch numbers them ascending, so
    PE order and group order differ and `order`/`index` invert each
    other."""
    mesh = RankMesh(("data", "model"), (2, 4), 5)
    g = spmd.AxisGroup(None, mesh.group(("model", "data")))
    assert g.ranks == (0, 4, 1, 5, 2, 6, 3, 7)
    assert not g.in_order
    assert g.order == [0, 2, 4, 6, 1, 3, 5, 7]
    assert [g.order[i] for i in g.index] == list(range(8))
    assert spmd.AxisGroup(None, mesh.group("model")).in_order


def _per_rank(ref, key, n=4):
    tree = _unflat(ref, key)
    flat = _flat(tree, "", {})
    return [{k: v[r] for k, v in flat.items()} for r in range(n)]


def _port_flat(tree, cfg):
    return _flat(convert.params_to_jax(tree, cfg), "", {})


def test_train_loss_and_every_gradient_leaf_match_reference(ref, port4):
    """qwen2's smoke step on 2x2 under xla: the loss and every rank's
    synced gradient leaf against the reference's xla side, and against
    the port's shmem side; no heap round under xla."""
    want = _per_rank(ref, "train/grads")
    cfg = _cfg(QWEN)
    for r, res in enumerate(port4):
        got = res["train"]
        np.testing.assert_allclose(got["xla"]["loss"], ref["train/loss"],
                                   **TOL)
        np.testing.assert_allclose(got["xla"]["loss"],
                                   got["shmem"]["loss"], **TOL)
        assert got["xla"]["rounds"] == 0 < got["shmem"]["rounds"]
        g = _port_flat(got["xla"]["grads"], cfg)
        gs = _port_flat(got["shmem"]["grads"], cfg)
        assert sorted(g) == sorted(want[r]) == sorted(gs)
        for k in g:
            np.testing.assert_allclose(g[k], want[r][k],
                                       err_msg=f"rank {r} {k}", **TOL)
            np.testing.assert_allclose(g[k], gs[k],
                                       err_msg=f"rank {r} {k}", **TOL)


@pytest.mark.parametrize("grad_rs", [False, "fused"])
def test_train_step_matches_reference(ref, port4, grad_rs):
    """A whole build_train_step step under xla (the launcher's
    make_train_step) against the reference's: loss and every rank's new
    parameters; no heap round."""
    want = _per_rank(ref, f"train/step_{grad_rs}/params")
    for r, res in enumerate(port4):
        loss, new, rounds = res["train"][f"step_{grad_rs}"]
        assert rounds == 0
        np.testing.assert_allclose(loss, ref[f"train/step_{grad_rs}/loss"],
                                   **TOL)
        got = _port_flat(new, _cfg(QWEN))
        for k in got:
            np.testing.assert_allclose(got[k], want[r][k],
                                       err_msg=f"rank {r} {k}", **TOL)


@pytest.mark.parametrize("grad_rs", [True, "fused"])
def test_grad_rs_under_xla_takes_the_per_bucket_sync(port4, grad_rs):
    """Under xla grad_rs True and "fused" sync each bucket with one
    grad_sync and run the optimizer apart, as the reference's: neither
    calls grad_sync_bucketed nor the fused update (which refuses xla),
    and the step is the default step bit for bit."""
    for res in port4:
        assert res["train"]["bucketed"] == []
        base = res["train"]["step_False"]
        got = res["train"][f"step_{grad_rs}"]
        assert got[0] == base[0]
        a, b = _port_flat(got[1], _cfg(QWEN)), _port_flat(base[1],
                                                          _cfg(QWEN))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fused_update_refuses_the_xla_backend():
    from repro_torch.parallel.comm import Comm
    with pytest.raises(ValueError, match="shmem backend only"):
        Comm(backend="xla").grad_sync_fused_update(
            [], [], [], [], 1.0, 1.0, lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
            wd_coef=0.0, out_dtypes=[])


def test_a_second_train_step_makes_no_process_group(port4):
    """The groups belong to the rank runtime, made once per axis: the
    first xla step on the mesh makes them, the later steps (each with a
    Comm of its own) make none."""
    for res in port4:
        first, *later = res["train"]["groups"]
        assert first > 0
        assert later == [first] * len(later)


def test_ring_under_xla_attends_each_shard_locally(ref, port4):
    """attention="ring" over a data axis of 2 under xla: each rank's
    rows attend over its own shard's keys, as the reference's (its ring
    runs on shmem only), and differ from the ring's rows on rank 1."""
    want = ref["ring/xla"]
    ls = want.shape[1] // 2
    for r, res in enumerate(port4):
        got = res["ring"]
        d = r % 2
        np.testing.assert_allclose(got["xla"].numpy(),
                                   want[:, d * ls:(d + 1) * ls], **TOL)
        if d == 1:
            assert not np.allclose(got["xla"].numpy(),
                                   got["shmem"].numpy(), **TOL)


def test_moe_layer_matches_reference_and_shmem(ref, port4):
    """Granite's smoke MoE layer on 1x4 under xla (the alltoall through
    gloo): output, aux and input gradient at rtol 1e-4 / atol 1e-5 of the
    reference's and of the shmem layer's, the picks exactly."""
    for r, res in enumerate(port4):
        got = res["moe"]
        for k in ("out", "aux", "gx"):
            np.testing.assert_allclose(got["xla"][k].numpy(),
                                       ref["moe/" + k][r],
                                       err_msg=f"rank {r} {k}", **TOL)
            np.testing.assert_allclose(got["xla"][k].numpy(),
                                       got["shmem"][k].numpy(),
                                       err_msg=f"rank {r} {k}", **TOL)
        np.testing.assert_array_equal(got["xla"]["tope"].numpy(),
                                      ref["moe/tope"][r])
        np.testing.assert_array_equal(got["xla"]["tope"].numpy(),
                                      got["shmem"]["tope"].numpy())


def test_serve_engine_takes_a_backend(port4):
    """ServeEngine(backend="xla") on 1x4: its Comm is the library's, it
    takes no heap round, and it serves the shmem engine's tokens, its
    captured logits at rtol 1e-4 / atol 1e-5."""
    for res in port4:
        xla, shm = res["engine"]["xla"], res["engine"]["shmem"]
        assert (xla["backend"], shm["backend"]) == ("xla", "shmem")
        assert xla["rounds"] == 0 < shm["rounds"]
        assert xla["calls"] > 0 == shm["calls"]
        for a, b in zip(xla["tokens"], shm["tokens"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(xla["logits"], shm["logits"]):
            np.testing.assert_allclose(a, b, **TOL)


def test_train_launcher_at_comm_xla_matches_reference_launcher(launch_ref):
    """`launch.train --comm xla --data 2 --model 2 --smoke` against the
    reference's launcher with the same flags, loss for loss, both from
    the reference launcher's seed-0 global parameters: bf16 compute, so
    within test_torch_tp's 2e-3."""
    from repro_torch.launch import train as train_mod
    cfg = smoke_config(QWEN)
    params = convert.params_from_jax(_unflat(launch_ref, "train/params"),
                                     cfg)
    got = train_mod.run(TRAIN_ARGV + ["--device", "cpu"],
                        params=params).losses
    assert len(got) == 3
    np.testing.assert_allclose(got, launch_ref["train/losses"], rtol=2e-3)


def test_serve_launcher_at_comm_xla_takes_the_dense_loop(launch_ref, capfd):
    """`launch.serve --comm xla --model 2 --smoke` serves qwen2 (a paged
    family) through the dense-cache decode loop, as the reference's, with
    the reference launcher's tokens (its seed-0 parameters, f32 compute
    on both sides)."""
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    cfg = _cfg(QWEN)
    params = convert.params_from_jax(_unflat(launch_ref, "serve/params"),
                                     cfg)
    orig = configs.smoke_config
    with mock.patch.object(configs, "smoke_config",
                           lambda a, **kw: orig(a, dtype=torch.float32,
                                                **kw)):
        got = launch_serve.run(SERVE_ARGV + ["--device", "cpu"],
                               params=params)
    assert "(dense loop, cpu on 1x2 ranks)" in capfd.readouterr().out
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got, launch_ref["serve/tokens"])


def test_no_port_module_refuses_the_xla_backend():
    """Every entry point takes --comm xla: the launchers parse it, Comm
    and the step builders accept it, and nothing in the package names
    it as unported."""
    from repro_torch.launch import serve as pserve
    from repro_torch.launch import train as ptrain
    from repro_torch.parallel.comm import Comm
    assert ptrain.parse_args(["--arch", QWEN, "--comm", "xla"]).comm == "xla"
    assert pserve._parser().parse_args(["--arch", QWEN, "--comm",
                                        "xla"]).comm == "xla"
    assert Comm(backend="xla").backend == "xla"
    with pytest.raises(ValueError, match="backend"):
        Comm(backend="nccl")
    src = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(src):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                assert "slice 5d" not in text, f


def test_one_device_xla_collectives_are_the_identity():
    """Outside a rank process every axis has one PE: the xla collectives
    are the identity (a psum over a size-1 axis), alltoall along two axes
    too."""
    from repro_torch.parallel.comm import Comm
    c = Comm(backend="xla")
    x = torch.randn(4, 6)
    for got in (c.allreduce(x, "model"), c.allgather(x, "model"),
                c.reduce_scatter(x, "model"), c.broadcast(x, "model", 1),
                c.alltoall(x, "model", split_axis=0, concat_axis=1),
                c.grad_sync(x), c.grad_sync_bucketed([x])[0]):
        assert torch.equal(got, x)


def test_launcher_help_names_no_slice():
    """The --comm help of both launchers describes the two backends."""
    from repro_torch.launch import serve as pserve
    from repro_torch.launch import train as ptrain
    for ap in (ptrain._parser(), pserve._parser()):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ap.print_help()
        assert "library collectives" in buf.getvalue()
        assert "slice" not in buf.getvalue()
