"""The pod axis and pipeline parallelism on the rank mesh against the
reference, on the CPU.  The reference runs in one subprocess with 8 host
devices (shard_map, `tests/test_pipeline.py`'s setup; its train
launcher), started first and left to run while the port's rank
processes run, and hands its numbers over as .npz.  The port's work runs
in one spawn of 4 ranks, each task on a mesh it makes (2 x (1 x 2), 2 x
2, 4 x (1 x 1), ...), and one of 8 ranks for the 2 x 4 gradient sync:

  (a) `pipeline.supported` for the ten archs;
  (b) smoke qwen2 in f32 on the reference test's own setup (batch 4 x 16
      from default_rng(0), parameters from the reference's
      `make_init_fn` at key 5 on 2 x 2, cut by stage): the pipelined loss
      over 2 stages at tp 2 for n_micro 1, 2 and 4 against the
      reference's `pipeline_train_loss` at rtol 1e-4 / atol 1e-5 and
      against the unpipelined 2 x 2 loss (`train_loss`, then the mean
      over `data`) at the reference test's 1e-4 x max(1, |ref|);
  (c) every gradient leaf on every rank against each device's of the
      reference's `jax.grad` of the pipelined loss under shard_map; and
      the factor between the pipelined and unpipelined gradients: a
      stage's layer leaf is the sum over the data ranks of the 2 x 2
      gradient of that layer, a pod-replicated leaf summed over the
      stages likewise;
  (d) 4 stages (pod 4, model 1) of a 4-layer cut;
  (e) hubert smoke through the `frames` path;
  (f) `grad_sync` (with and without `grad_rs`) and `grad_sync_bucketed`
      over pod 2 x data 2, and the reference's no-leak case of a
      data-axis rank order on pod 2 x data 4; the fused sync refuses a
      pod;
  (g) the train launcher at --pod 2 --data 1 --model 2, 2 steps, losses
      and final checkpoint against the reference launcher's, and bit for
      bit against the port's own --data 2 --model 2;
  (h) `make_serve_steps` prefill and decode on (pod 2, data 1, model 1)
      and, on (pod 2, data 2, model 1), a decode cell whose batch is
      below dp x pod but not below dp: seq_shards = dp.

Float results are held at rtol 1e-4 / atol 1e-5 (f32 smoke configs on
both sides)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core.heap import tree_flatten, tree_unflatten
from repro_torch.launch import build
from repro_torch.models import convert, transformer
from repro_torch.parallel import pipeline, sharding
from repro_torch.parallel.comm import AxisSpec, Comm

ROOT = os.path.join(os.path.dirname(__file__), "..")
QWEN, HUBERT = "qwen2-0.5b", "hubert-xlarge"
TOL = dict(rtol=1e-4, atol=1e-5)
N_MICRO = (1, 2, 4)
SLOT = 1 << 16                    # heap slot bytes: payloads cross in chunks
SYNC_N = 1000                     # gradient-sync payload (not a multiple of 4)
LAUNCH_ARGV = ["--arch", QWEN, "--smoke", "--model", "2", "--steps", "2",
               "--seq-len", "16", "--batch", "4"]
POD_ARGV = LAUNCH_ARGV + ["--pod", "2", "--data", "1"]
DP_ARGV = LAUNCH_ARGV + ["--data", "2"]
# make_serve_steps' cells, patched into both SHAPES
CELLS = {"pp_prefill": dict(seq_len=8, global_batch=4, kind="prefill"),
         "pp_decode": dict(seq_len=16, global_batch=4, kind="decode"),
         "pp_long": dict(seq_len=16, global_batch=2, kind="decode")}
DEC_STEPS = 4

REF_SCRIPT = textwrap.dedent("""
    import os, sys, json, dataclasses, glob
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.configs as C
    from repro.core.topology import MeshTopology
    from repro.launch import build
    from repro.launch.mesh import make_mesh
    from repro.models import config as mconfig
    from repro.models import transformer
    from repro.parallel import pipeline, sharding
    from repro.parallel.comm import AxisSpec, Comm

    out = {}
    real_smoke = C.smoke_config

    def f32(arch, **kw):
        return real_smoke(arch, dtype=jnp.float32, **kw)

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                flat(tree[k], prefix + "/" + k)
        else:
            out[prefix] = np.asarray(tree)

    def put(mesh, tree, specs):
        return jax.tree.map(lambda a, s: jax.device_put(
            jnp.asarray(a), NamedSharding(mesh, s)), tree, specs)

    def pp_specs(specs):
        def one(kp, sp):
            path = tuple(str(getattr(k, "key", k)) for k in kp)
            if sharding._is_stacked(path):
                return P(*(("pod",) + tuple(sp)[1:]))
            return sp
        return jax.tree_util.tree_map_with_path(one, specs)

    def per_device(fn, mesh, in_specs, tree_specs):
        # each device's loss and gradient, stacked in mesh (rank) order
        st = P(tuple(mesh.axis_names))
        def body(p, b):
            l, g = jax.value_and_grad(fn)(p, b)
            return l[None], jax.tree.map(lambda x: x[None], g)
        return jax.jit(build.shard_mapped(
            body, mesh, in_specs, (st, jax.tree.map(lambda _: st,
                                                    tree_specs))))

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, 128, (4, 16)).astype(np.int32),
             "targets": rng.integers(1, 128, (4, 16)).astype(np.int32)}
    jb = jax.tree.map(jnp.asarray, batch)
    hcfg = f32(HUBERT)
    hrng = np.random.default_rng(1)
    hbatch = {"frames": hrng.standard_normal(
                  (4, 16, hcfg.d_model)).astype(np.float32),
              "targets": hrng.integers(1, hcfg.vocab, (4, 16)).astype(
                  np.int32)}
    out["hubert/frames"] = hbatch["frames"]
    out["hubert/targets"] = hbatch["targets"]

    def pipe_fn(cfg, n_micro):
        def fn(p, b):
            comm = Comm(AxisSpec(pod="pod"), "shmem")
            return pipeline.pipeline_train_loss(comm, cfg, p, b,
                                                n_micro=n_micro)
        return fn

    def pipelined(tag, cfg, gp, b, mesh_dims, n_micros):
        mesh = make_mesh(*mesh_dims)
        with jax.set_mesh(mesh):
            _, specs = build.abstract_params(cfg, mesh)
            sp = pp_specs(specs)
            params = put(mesh, gp, sp)
            bspec = {k: P(*(None,) * np.ndim(v)) for k, v in b.items()}
            for n in n_micros:
                l, g = per_device(pipe_fn(cfg, n), mesh, (sp, bspec), sp)(
                    params, jax.tree.map(jnp.asarray, b))
                out[f"{tag}/{n}/loss"] = np.asarray(l)
                flat(g, f"{tag}/{n}/grads")

    def unpipelined(tag, cfg, gp, b, dims):
        mesh = make_mesh(*dims)
        with jax.set_mesh(mesh):
            _, specs = build.abstract_params(cfg, mesh)
            def fn(p, bt):
                comm = Comm(AxisSpec(), "shmem")
                l = transformer.train_loss(comm, cfg, p, bt)
                return comm.allreduce(l, "data") / comm.axis_size("data")
            bspec = {k: P("data", *(None,) * (np.ndim(v) - 1))
                     for k, v in b.items()}
            l, g = per_device(fn, mesh, (specs, bspec), specs)(
                put(mesh, gp, specs), jax.tree.map(jnp.asarray, b))
            out[f"{tag}/loss"] = np.asarray(l)
            flat(g, f"{tag}/grads")

    def init(cfg, dims):
        mesh = make_mesh(*dims)
        with jax.set_mesh(mesh):
            init_fn, _, _ = build.make_init_fn(cfg, mesh)
            return jax.tree.map(np.asarray, jax.jit(init_fn)(
                jax.random.key(5)))

    # (b), (c): smoke qwen2 over 2 stages at tp 2
    cfg = f32(QWEN)
    assert pipeline.supported(cfg)
    gp = init(cfg, (2, 2))
    flat(gp, "qwen/init")
    unpipelined("qwen/unpp", cfg, gp, batch, (2, 2))
    pipelined("qwen/pp", cfg, gp, batch, (1, 2, 2), N_MICRO)
    # (d): 4 stages of a 4-layer cut at tp 1
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    gp4 = init(cfg4, (1, 1))
    flat(gp4, "pp4/init")
    unpipelined("pp4/unpp", cfg4, gp4, batch, (1, 1))
    pipelined("pp4/pp", cfg4, gp4, batch, (1, 1, 4), (4,))
    # (e): hubert through the frames path
    gph = init(hcfg, (2, 2))
    flat(gph, "hubert/init")
    unpipelined("hubert/unpp", hcfg, gph, hbatch, (2, 2))
    pipelined("hubert/pp", hcfg, gph, hbatch, (1, 2, 2), (2,))

    # (f): the gradient syncs over pod 2 x data 2, and the no-leak case
    xs = np.random.default_rng(2).standard_normal((8, SYNC_N)).astype(
        np.float32)
    out["sync/x"] = xs
    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    st = P(("pod", "data"))
    for name, kw in (("plain", {}), ("rs", {"grad_rs": True})):
        def gs(v, kw=kw):
            c = Comm(AxisSpec(data="data", model=None, pod="pod"), "shmem",
                     **kw)
            return c.grad_sync(v, mean=True)
        out[f"sync/{name}"] = np.asarray(jax.jit(build.shard_mapped(
            gs, mesh, (st,), st))(jnp.asarray(xs[:4])))
    def gsb(v):
        c = Comm(AxisSpec(data="data", model=None, pod="pod"), "shmem")
        return tuple(c.grad_sync_bucketed([v, v * 2.0], mean=True))
    b1, b2 = jax.jit(build.shard_mapped(gsb, mesh, (st,), (st, st)))(
        jnp.asarray(xs[:4]))
    out["sync/bucketed0"], out["sync/bucketed1"] = np.asarray(b1), \\
        np.asarray(b2)
    mesh8 = jax.make_mesh((2, 4), ("pod", "data"))
    def gs_pod(v):
        c = Comm(AxisSpec(data="data", model=None, pod="pod"), "shmem",
                 grad_rs=True, topo=MeshTopology((2, 2), torus=(False, False)),
                 embedding=(0, 1, 3, 2))
        return c.grad_sync(v, mean=True)
    out["sync/noleak"] = np.asarray(jax.jit(build.shard_mapped(
        gs_pod, mesh8, (st,), st))(jnp.asarray(xs)))

    # (h): make_serve_steps on a pod mesh, from a tp-1 tree
    mconfig.SHAPES.update(CELLS)
    gps = init(cfg, (1, 1))
    flat(gps, "serve/init")
    toks = np.random.default_rng(3).integers(1, 128, (4, 16)).astype(
        np.int32)
    out["serve/tokens"] = toks
    for cell, dims in (("pp_prefill", (1, 1, 2)), ("pp_decode", (1, 1, 2)),
                       ("pp_long", (2, 1, 2))):
        mesh = make_mesh(*dims)
        spec = CELLS[cell]
        B = spec["global_batch"]
        with jax.set_mesh(mesh):
            pre, dec, (cshapes, cspecs), (_, pspecs), ss = \\
                build.make_serve_steps(cfg, mesh, cell)
            out[f"serve/{cell}/seq_shards"] = np.asarray(ss)
            params = put(mesh, gps, pspecs)
            if spec["kind"] == "prefill":
                bt = {"tokens": jnp.asarray(toks[:B, :spec["seq_len"]])}
                out[f"serve/{cell}/logits"] = np.asarray(
                    jax.jit(pre(bt))(params, bt))
                continue
            for k, leaf in jax.tree_util.tree_leaves_with_path(cshapes):
                path = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                                for q in k)
                out[f"serve/{cell}/shape/{path}"] = np.asarray(leaf.shape)
            bl = B // (dims[0] * dims[2]) if ss == 1 else B
            cache = jax.jit(build.shard_mapped(
                lambda: transformer.init_cache(cfg, 1, bl, spec["seq_len"],
                                               ss), mesh, (), cspecs))()
            bt = {"tokens": jnp.asarray(toks[:B, :1]),
                  "positions": jnp.zeros((B,), jnp.int32)}
            dstep = jax.jit(dec(bt))
            lgs = []
            for t in range(DEC_STEPS):
                lg, cache = dstep(params, cache, {
                    "tokens": jnp.asarray(toks[:B, t:t + 1]),
                    "positions": jnp.full((B,), t, jnp.int32)})
                lgs.append(np.asarray(lg))
            out[f"serve/{cell}/logits"] = np.stack(lgs)

    # (g): the train launcher at --pod 2 --data 1 --model 2, f32 smoke
    from repro.launch import train as train_mod
    C.smoke_config = f32
    out["launch/losses"] = np.asarray(train_mod.main(
        POD_ARGV + ["--ckpt-dir", sys.argv[2]]))
    step = sorted(glob.glob(sys.argv[2] + "/step-*"))[-1]
    for rec in json.load(open(step + "/manifest.json"))["leaves"]:
        if rec["name"].startswith("params/"):
            out["launch/ckpt/" + rec["name"]] = np.load(
                step + "/" + rec["file"])
    mesh = make_mesh(1, 2, pod=2)
    with jax.set_mesh(mesh):
        init_fn, _, _ = build.make_init_fn(f32(QWEN), mesh)
        flat(jax.tree.map(np.asarray, jax.jit(init_fn)(jax.random.key(0))),
             "launch/init")
    np.savez(sys.argv[1], **out)
    print("REF-OK")
""")


def _unflat(arrs, prefix):
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


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], prefix + "/" + k, out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _cfg(arch, **kw):
    return smoke_config(arch, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference subprocess, started first and left to run while the
    port's ranks run."""
    d = tmp_path_factory.mktemp("pipeline")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    head = (f"QWEN, HUBERT = {QWEN!r}, {HUBERT!r}\nN_MICRO = {N_MICRO!r}\n"
            f"SYNC_N = {SYNC_N!r}\nPOD_ARGV = {POD_ARGV!r}\n"
            f"CELLS = {CELLS!r}\nDEC_STEPS = {DEC_STEPS!r}\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", head + REF_SCRIPT, str(d / "ref.npz"),
         str(d / "ref_ckpt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_run):
    proc, d = ref_run
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0 and "REF-OK" in out, err[-4000:]
    return dict(np.load(d / "ref.npz"))


# ---------------------------------------------------------------------------
# the rank bodies
# ---------------------------------------------------------------------------

def rank_body(tasks):
    """One rank: each (key, name, args) of `tasks` through
    `_task_<name>`, in order, each on the mesh it makes; their results
    by key."""
    return {key: globals()[f"_task_{name}"](*args)
            for key, name, args in tasks}


def _rt():
    from repro_torch.core import spmd
    return spmd.current()


def _mesh(dims, names):
    from repro_torch.launch.mesh import make_rank_mesh
    return make_rank_mesh(dims, names)


def _value_and_grad(fn, params):
    """(loss, gradient tree) of fn(params) by autograd; a leaf the loss
    does not read gets zeros, as jax.grad gives it."""
    leaves, treedef = tree_flatten(params)
    req = [l.detach().requires_grad_() for l in leaves]
    with torch.enable_grad():
        loss = fn(tree_unflatten(treedef, req))
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
    return float(loss), tree_unflatten(treedef, list(grads))


def _task_pipeline(cfg, gp, batch, dims, n_micros):
    """The pipelined loss and every gradient leaf of this rank's stage,
    on the (pod, data, model) mesh `dims`, for each of `n_micros`."""
    mesh = _mesh(dims, ("pod", "data", "model"))
    local = convert.shards_from_jax(gp, cfg, mesh)
    stage = sharding.pipeline_stage(local, mesh.coords["pod"],
                                    mesh.sizes["pod"])
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = {}
    for n in n_micros:
        comm = Comm(AxisSpec(pod="pod"))
        out[n] = _value_and_grad(lambda p: pipeline.pipeline_train_loss(
            comm, cfg, p, b, n_micro=n), stage)
    return out


def _task_unpipelined(cfg, gp, batch, dims):
    """train_loss on this rank's data slice, then the mean over `data`
    (the reference test's `fn`), with every gradient leaf."""
    mesh = _mesh(dims, ("data", "model"))
    local = convert.shards_from_jax(gp, cfg, mesh)
    b = {k: torch.as_tensor(v) for k, v in
         build.local_batch(cfg, batch, mesh).items()}
    comm = Comm(AxisSpec())

    def fn(p):
        loss = transformer.train_loss(comm, cfg, p, b)
        return comm.allreduce(loss, "data") / comm.axis_size("data")

    return _value_and_grad(fn, local)


def _task_sync(xs):
    """grad_sync with and without grad_rs and grad_sync_bucketed over pod
    2 x data 2: this rank's row of each, and the heap rounds of the
    plain sync."""
    _mesh((2, 2), ("pod", "data"))
    rt = _rt()
    x = torch.as_tensor(xs[rt.rank:rt.rank + 1])
    axes = AxisSpec(data="data", model=None, pod="pod")
    r0 = rt.rounds
    got = {"plain": Comm(axes).grad_sync(x, mean=True)}
    got["rounds"] = rt.rounds - r0
    got["rs"] = Comm(axes, grad_rs=True).grad_sync(x, mean=True)
    got["bucketed0"], got["bucketed1"] = Comm(axes).grad_sync_bucketed(
        [x, x * 2.0], mean=True)
    return got


def _task_noleak(xs):
    """The reference's no-leak case: a data-axis rank order and topology
    on pod 2 x data 4 with grad_rs; the pod axis (2 PEs) must not take
    the 4-PE embedding."""
    from repro_torch.core.topology import MeshTopology
    _mesh((2, 4), ("pod", "data"))
    r = _rt().rank
    c = Comm(AxisSpec(data="data", model=None, pod="pod"), grad_rs=True,
             topo=MeshTopology((2, 2), torus=(False, False)),
             embedding=(0, 1, 3, 2))
    pod_net = c._net("pod", torch.device("cpu"))
    return {"out": c.grad_sync(torch.as_tensor(xs[r:r + 1]), mean=True),
            "pod_topo": c._topo_for(pod_net) is None,
            "pod_emb": c._embedding_for(pod_net)}


def _task_launch(init, ckpt_dirs):
    """The launcher's loop at --pod 2 --data 1 --model 2, then at --data
    2 --model 2, from the reference launcher's seed-0 tree, f32 smoke,
    each with a checkpoint of its final state."""
    import repro_torch.configs as C
    from repro_torch.launch import train as train_mod
    real = C.smoke_config
    C.smoke_config = lambda arch, **kw: real(arch, dtype=torch.float32,
                                            **kw)
    out = {}
    try:
        for key, argv, dims, names in (
                ("pod", POD_ARGV, (2, 1, 2), ("pod", "data", "model")),
                ("dp", DP_ARGV, (2, 2), ("data", "model"))):
            _mesh(dims, names)
            out[key] = train_mod.train_loop(train_mod.parse_args(
                argv + ["--device", "cpu", "--ckpt-dir", ckpt_dirs[key],
                        "--ckpt-async", "off"]), init).losses
    finally:
        C.smoke_config = real
    return out


def _task_serve(gp, toks):
    """make_serve_steps on a pod mesh: the prefill cell's and the decode
    cell's logits on (pod 2, data 1, model 1), two such meshes side by
    side (`rep`); then the long cell's decode on (pod 2, data 2, model
    1).  Each rank's logits, cache shapes and seq_shards."""
    from repro_torch.models import config as mconfig
    mconfig.SHAPES.update(CELLS)
    cfg = _cfg(QWEN)
    out = {}
    for cell, dims, names in (
            ("pp_prefill", (2, 2, 1, 1), ("rep", "pod", "data", "model")),
            ("pp_decode", (2, 2, 1, 1), ("rep", "pod", "data", "model")),
            ("pp_long", (2, 2, 1), ("pod", "data", "model"))):
        mesh = _mesh(dims, names)
        pre, dec, (cshapes, _), _, ss = build.make_serve_steps(cfg, mesh,
                                                               cell)
        params = convert.shards_from_jax(gp, cfg, mesh)
        spec = CELLS[cell]
        B = spec["global_batch"]
        if spec["kind"] == "prefill":
            out[cell] = {"logits": pre(params, {
                "tokens": toks[:B, :spec["seq_len"]]}), "seq_shards": ss}
            continue
        cache = transformer.map_params(
            lambda t: torch.zeros(t.shape, dtype=t.dtype), cshapes)
        lgs = []
        for t in range(DEC_STEPS):
            lg, cache = dec(params, cache, {
                "tokens": toks[:B, t:t + 1],
                "positions": np.full((B,), t)})
            lgs.append(lg.clone())
        out[cell] = {"logits": torch.stack(lgs), "seq_shards": ss,
                     "shapes": transformer.map_params(
                         lambda t: tuple(t.shape), cshapes)}
    return out


@pytest.fixture(scope="module")
def inputs(ref):
    """The reference's parameter trees and the batches (numpy)."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, 128, (4, 16)).astype(np.int32),
             "targets": rng.integers(1, 128, (4, 16)).astype(np.int32)}
    return {"batch": batch,
            "hbatch": {"frames": ref["hubert/frames"],
                       "targets": ref["hubert/targets"]},
            "qwen": _unflat(ref, "qwen/init"),
            "pp4": _unflat(ref, "pp4/init"),
            "hubert": _unflat(ref, "hubert/init"),
            "serve": _unflat(ref, "serve/init"),
            "launch": convert.params_from_jax(_unflat(ref, "launch/init"),
                                              _cfg(QWEN))}


@pytest.fixture(scope="module")
def port(ref, inputs, tmp_path_factory):
    """Every rank's results: one spawn of 4 ranks, one of 8."""
    d = tmp_path_factory.mktemp("pipeline_port")
    cfg, hcfg = _cfg(QWEN), _cfg(HUBERT)
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    dirs = {k: str(d / k) for k in ("pod", "dp")}
    tasks = [
        ("pp", "pipeline", (cfg, inputs["qwen"], inputs["batch"],
                            (2, 1, 2), N_MICRO)),
        ("unpp", "unpipelined", (cfg, inputs["qwen"], inputs["batch"],
                                 (2, 2))),
        ("pp4", "pipeline", (cfg4, inputs["pp4"], inputs["batch"],
                             (4, 1, 1), (4,))),
        ("hubert", "pipeline", (hcfg, inputs["hubert"], inputs["hbatch"],
                                (2, 1, 2), (2,))),
        ("hubert_unpp", "unpipelined", (hcfg, inputs["hubert"],
                                        inputs["hbatch"], (2, 2))),
        ("sync", "sync", (ref["sync/x"][:4],)),
        ("serve", "serve", (inputs["serve"], ref["serve/tokens"])),
        ("launch", "launch", (inputs["launch"], dirs))]
    out = {"4": build.shard_mapped(rank_body, (4, 1), [(tasks,)] * 4,
                                   device="cpu", slot_bytes=SLOT),
           "dirs": dirs}
    out["8"] = build.shard_mapped(
        rank_body, (8, 1), [([("noleak", "noleak", (ref["sync/x"],))],)]
        * 8, device="cpu", slot_bytes=SLOT)
    return out


def _rank(port, r):
    return port["4"][r]


def _assert_tree(got, want, prefix, r, **tol):
    """The port's tree `got` (its layout) against the reference's stacked
    per-device arrays under `prefix`, row `r`."""
    flat = _flat(got, prefix, {})
    keys = sorted(k for k in want if k.startswith(prefix + "/"))
    assert sorted(flat) == keys
    for k in keys:
        np.testing.assert_allclose(flat[k], want[k][r], err_msg=k,
                                   **(tol or TOL))
    return len(keys)


# ---------------------------------------------------------------------------
# (a) supported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_supported_equals_the_reference(arch):
    """Full and smoke configs alike."""
    from repro.configs import get_config as jget
    from repro.configs import smoke_config as jsmoke
    from repro.parallel import pipeline as jpipe
    assert pipeline.supported(get_config(arch)) == \
        jpipe.supported(jget(arch))
    assert pipeline.supported(smoke_config(arch)) == \
        jpipe.supported(jsmoke(arch))


def test_pipeline_stage_cuts_the_layer_list():
    cfg = _cfg(QWEN, n_layers=6)
    p = transformer.init_params(cfg, device="meta")
    for s in range(3):
        got = sharding.pipeline_stage(p, s, 3)
        assert got["layers"] == p["layers"][2 * s:2 * s + 2]
        assert got["embed"] is p["embed"]
    with pytest.raises(ValueError, match="do not split into 4"):
        sharding.pipeline_stage(p, 0, 4)


def test_pipeline_on_one_device_is_train_loss():
    """Outside a rank mesh the pod axis has one stage: the pipelined loss
    is `train_loss` of the batch, for any microbatch count."""
    cfg = _cfg(QWEN)
    p = transformer.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    b = {k: torch.as_tensor(rng.integers(1, cfg.vocab, (4, 16)))
         for k in ("tokens", "targets")}
    want = float(transformer.train_loss(Comm(), cfg, p, b))
    for n in N_MICRO:
        got = float(pipeline.pipeline_train_loss(Comm(), cfg, p, b,
                                                 n_micro=n))
        assert abs(got - want) < 1e-5 * max(1.0, abs(want))
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_train_loss(Comm(), cfg, p, b, n_micro=3)


# ---------------------------------------------------------------------------
# (b), (c) two stages at tp 2; (d) four stages; (e) hubert's frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_micro", N_MICRO)
def test_pipelined_loss_matches_reference_and_unpipelined(ref, port,
                                                          n_micro):
    """Every rank's pipelined loss against the reference's at rtol 1e-4 /
    atol 1e-5, and against the unpipelined 2 x 2 loss at the reference
    test's 1e-4 x max(1, |ref|)."""
    unpp = float(ref["qwen/unpp/loss"][0])
    for r in range(4):
        loss = _rank(port, r)["pp"][n_micro][0]
        np.testing.assert_allclose(loss, ref[f"qwen/pp/{n_micro}/loss"][r],
                                   **TOL)
        assert abs(loss - unpp) < 1e-4 * max(1.0, abs(unpp))
        np.testing.assert_allclose(_rank(port, r)["unpp"][0],
                                   ref["qwen/unpp/loss"][r], **TOL)


@pytest.mark.parametrize("n_micro", N_MICRO)
def test_pipelined_gradient_every_leaf_every_rank(ref, port, n_micro):
    """Each rank's gradient, leaf by leaf (its stage's 1 layer, the
    embedding and final norm it holds whole), against each device's of
    the reference's jax.grad under shard_map; finite, not all zero."""
    cfg = _cfg(QWEN)
    total = 0.0
    for r in range(4):
        g = _rank(port, r)["pp"][n_micro][1]
        n = _assert_tree(convert.params_to_jax(g, cfg),
                         ref, f"qwen/pp/{n_micro}/grads", r)
        assert n == len(tree_flatten(g)[0])
        total += sum(float(t.abs().sum()) for t in tree_flatten(g)[0])
    assert np.isfinite(total) and total > 0


def test_unpipelined_gradient_every_leaf_every_rank(ref, port):
    cfg = _cfg(QWEN)
    for r in range(4):
        _assert_tree(convert.params_to_jax(_rank(port, r)["unpp"][1], cfg),
                     ref, "qwen/unpp/grads", r)


def _grad_factor_check(port, key, unpp_key, n_micro, cfg):
    """A stage's layer leaf on rank (s, 0, m) is the sum over the data
    ranks d of the 2 x 2 gradient (d, m) of the same layer; a leaf
    replicated over `pod` summed over the stages is that sum too."""
    P, per = 2, cfg.n_layers // 2
    for m in range(2):
        unpp = [_rank(port, d * 2 + m)[unpp_key][1] for d in range(2)]
        pp = [_rank(port, s * 2 + m)[key][n_micro][1] for s in range(P)]
        for s in range(P):
            for j in range(per):
                got = tree_flatten(pp[s]["layers"][j])[0]
                want = [a + b for a, b in zip(
                    tree_flatten(unpp[0]["layers"][s * per + j])[0],
                    tree_flatten(unpp[1]["layers"][s * per + j])[0])]
                for a, b in zip(got, want):
                    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        for name in ("embed", "final_norm"):
            got = [sum(x) for x in zip(*(tree_flatten(p[name])[0]
                                         for p in pp))]
            want = [sum(x) for x in zip(*(tree_flatten(u[name])[0]
                                          for u in unpp))]
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("n_micro", N_MICRO)
def test_pipelined_gradient_is_the_data_sum_of_the_unpipelined(port,
                                                               n_micro):
    """The factor the card's 21b gate uses: pipelined = sum over data."""
    _grad_factor_check(port, "pp", "unpp", n_micro, _cfg(QWEN))


def test_four_stages_match_reference(ref, port):
    """pod 4, model 1, a 4-layer cut, 4 microbatches: loss (also against
    the 1 x 1 train_loss) and every gradient leaf on every rank."""
    cfg4 = _cfg(QWEN, n_layers=4)
    unpp = float(ref["pp4/unpp/loss"][0])
    total = 0.0
    for r in range(4):
        loss, g = _rank(port, r)["pp4"][4]
        np.testing.assert_allclose(loss, ref["pp4/pp/4/loss"][r], **TOL)
        assert abs(loss - unpp) < 1e-4 * max(1.0, abs(unpp))
        assert len(g["layers"]) == 1
        _assert_tree(convert.params_to_jax(g, cfg4), ref, "pp4/pp/4/grads",
                     r)
        total += float(sum(t.abs().sum() for t in tree_flatten(g)[0]))
    assert np.isfinite(total) and total > 0


def test_hubert_frames_pipeline_matches_reference(ref, port):
    """hubert's smoke config through the `frames` path over 2 stages at
    tp 2: loss and every gradient leaf on every rank (the unread token
    table's zeros included), and the data-sum factor."""
    hcfg = _cfg(HUBERT)
    unpp = float(ref["hubert/unpp/loss"][0])
    for r in range(4):
        loss, g = _rank(port, r)["hubert"][2]
        np.testing.assert_allclose(loss, ref["hubert/pp/2/loss"][r], **TOL)
        assert abs(loss - unpp) < 1e-4 * max(1.0, abs(unpp))
        _assert_tree(convert.params_to_jax(g, hcfg), ref,
                     "hubert/pp/2/grads", r)
        _assert_tree(convert.params_to_jax(_rank(port, r)["hubert_unpp"][1],
                                           hcfg), ref, "hubert/unpp/grads",
                     r)
    _grad_factor_check(port, "hubert", "hubert_unpp", 2, hcfg)


# ---------------------------------------------------------------------------
# (f) the gradient syncs over pod x data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "rs", "bucketed0", "bucketed1"])
def test_grad_sync_over_pod_and_data_matches_reference(ref, port, case):
    """Each rank's synced row against each device's of the reference's,
    and against the plain mean over the 4 rows (x2 for the second
    bucket)."""
    xs = ref["sync/x"][:4]
    mean = xs.mean(0) * (2.0 if case == "bucketed1" else 1.0)
    for r in range(4):
        got = _rank(port, r)["sync"][case].numpy()
        np.testing.assert_allclose(got, ref[f"sync/{case}"][r:r + 1], **TOL)
        np.testing.assert_allclose(got[0], mean, rtol=1e-5, atol=1e-6)


def test_grad_sync_reduces_within_pods_then_across(port):
    """The plain sync of 4000 bytes is one recursive-doubling round over
    `data`, then one over `pod`: 2 heap rounds on every rank."""
    assert [_rank(port, r)["sync"]["rounds"] for r in range(4)] == [2] * 4


def test_data_axis_rank_order_does_not_leak_to_pod(ref, port):
    """`test_congestion.py`'s case at its own 2 x 4 mesh: an explicit
    data-axis rank order over a 4-PE topology, grad_rs, the pod axis of
    2 PEs without it; each rank's mean against the reference's."""
    xs = ref["sync/x"]
    for r, res in enumerate(port["8"]):
        got = res["noleak"]
        assert got["pod_topo"] and got["pod_emb"] is None
        np.testing.assert_allclose(got["out"].numpy(),
                                   ref["sync/noleak"][r:r + 1], **TOL)
        np.testing.assert_allclose(got["out"].numpy()[0], xs.mean(0),
                                   rtol=1e-5, atol=1e-5)


def test_fused_sync_refuses_a_pod_axis():
    comm = Comm(AxisSpec(pod="pod"))
    with pytest.raises(ValueError, match="pod axis"):
        comm.grad_sync_fused_update([], [], [], [], 1.0, 1.0, lr=1e-3,
                                    b1=0.9, b2=0.95, eps=1e-8, wd_coef=0.0,
                                    out_dtypes=[])
    from repro_torch.train import step as tstep
    cfg = _cfg(QWEN)
    p = transformer.init_params(cfg, device="cpu")
    step = tstep.build_train_step(cfg, AxisSpec(pod="pod"),
                                  grad_rs="fused")
    b = {k: np.ones((2, 4), np.int32) for k in ("tokens", "targets")}
    with pytest.raises(ValueError, match="pod axis"):
        step(p, tstep.init_fused_opt_state(p), b)


# ---------------------------------------------------------------------------
# (g) the train launcher with --pod
# ---------------------------------------------------------------------------

def _load_params(d):
    step = sorted(pathlib.Path(d).glob("step-*"))[-1]
    out = {}
    for rec in json.loads((step / "manifest.json").read_text())["leaves"]:
        if rec["name"].startswith("params/"):
            out[rec["name"]] = np.load(step / rec["file"])
    return out


def _port_ckpt_in_reference_layout(d, cfg):
    gp = {}
    for name, a in _load_params(d).items():
        node = gp
        parts = name.split("/")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(a)

    def lists(t):
        if isinstance(t, dict):
            if all(k.isdigit() for k in t):
                return [lists(t[str(i)]) for i in range(len(t))]
            return {k: lists(v) for k, v in t.items()}
        return t

    return _flat(convert.params_to_jax(lists(gp), cfg), "params", {})


def test_pod_launcher_matches_reference_launcher(ref, port):
    """--pod 2 --data 1 --model 2, 2 steps from the reference launcher's
    seed-0 tree: the losses and the final checkpoint's parameters
    against the reference launcher's."""
    got = _rank(port, 0)["launch"]["pod"]
    assert [_rank(port, r)["launch"]["pod"] for r in range(4)] == [got] * 4
    np.testing.assert_allclose(got, ref["launch/losses"], **TOL)
    flat = _port_ckpt_in_reference_layout(port["dirs"]["pod"], _cfg(QWEN))
    want = {k[len("launch/ckpt/"):]: v for k, v in ref.items()
            if k.startswith("launch/ckpt/")}
    assert sorted(flat) == sorted(want)
    for k in flat:
        np.testing.assert_allclose(flat[k], want[k], err_msg=k, **TOL)


def test_pod_launcher_equals_the_data_launcher_bitwise(port):
    """Over (pod 2, data 1) the batch splits as over data 2 and the pod
    allreduce runs the data allreduce's algorithm over 2 PEs: the losses
    and every parameter of the final checkpoint are the --data 2 --model
    2 run's, bit for bit."""
    res = _rank(port, 0)["launch"]
    assert res["pod"] == res["dp"]
    a = _load_params(port["dirs"]["pod"])
    b = _load_params(port["dirs"]["dp"])
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_pod_launcher_drops_embedding_without_topo(capsys):
    from repro_torch.launch import train as train_mod
    args = train_mod.parse_args(LAUNCH_ARGV + ["--pod", "2",
                                               "--embedding", "snake"])
    assert train_mod._topology(args) is None
    assert args.embedding == "off"
    assert "--embedding ignored: with --pod" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (h) make_serve_steps on a pod mesh
# ---------------------------------------------------------------------------

def test_make_serve_steps_on_a_pod_mesh_matches_reference(ref, port):
    """The prefill and decode cells on (pod 2, data 1, model 1): each
    rank's logits are the rows of the reference's global logits its pod
    index owns (the batch over (pod, data), pod-major), seq_shards 1."""
    for r in range(4):
        res = _rank(port, r)["serve"]
        pod = r % 2                      # (rep, pod, data, model) row-major
        for cell in ("pp_prefill", "pp_decode"):
            got = res[cell]
            assert got["seq_shards"] == int(ref[f"serve/{cell}/seq_shards"])
            want = ref[f"serve/{cell}/logits"]
            bl = CELLS[cell]["global_batch"] // 2
            rows = slice(pod * bl, (pod + 1) * bl)
            want = want[rows] if cell == "pp_prefill" else want[:, rows]
            np.testing.assert_allclose(got["logits"].numpy(), want,
                                       err_msg=f"{cell} rank {r}", **TOL)


def test_make_serve_steps_shards_the_sequence_over_data_only(ref, port):
    """A decode cell of 2 sequences on (pod 2, data 2, model 1): below dp
    x pod, so the cache's sequence is sharded, over `data` alone
    (seq_shards = dp = 2, the reference's count), the batch whole on
    every rank; logits of every step against the reference's."""
    want = ref["serve/pp_long/logits"]
    for r in range(4):
        got = _rank(port, r)["serve"]["pp_long"]
        assert got["seq_shards"] == int(ref["serve/pp_long/seq_shards"]) \
            == 2
        for i, c in enumerate(got["shapes"]["layers"]):
            assert list(c["k"]) == list(ref[
                "serve/pp_long/shape/layers/k"][1:])
            assert c["k"][1] == CELLS["pp_long"]["seq_len"] // 2
        np.testing.assert_allclose(got["logits"].numpy(), want,
                                   err_msg=f"rank {r}", **TOL)
