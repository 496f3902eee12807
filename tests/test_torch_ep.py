"""Expert parallelism and the Mamba2 and MLA layers at tp > 1 on the rank
mesh against the reference's shard_map, on the CPU: granite-moe (EP over
`model`), mamba2 and zamba2 (SSM heads over `model`, B and C replicated)
and deepseek-v3 (MLA heads over `model`, EP over the flattened (data,
model) with `ep_over_data` set by `dataclasses.replace` on both sides),
smoke configs in f32 compute, each on a 2x2 and a 1x4 mesh of rank
processes (gloo, a shared-memory heap of small slots, so payloads cross
in chunks), and deepseek also on a 2x1 mesh (EP over `data` alone, tp =
1), from the same global parameters:

  * every rank's loss (the data-axis mean; the MoE aux loss is each
    rank's own) against that device's in the reference;
  * every gradient leaf of every rank after the data-axis sync, the
    unsynced expert leaves under `ep_over_data` included;
  * one `build_train_step` step with the default sync, and with the
    fused one where every leaf is data-replicated (under `ep_over_data`
    it raises, as the reference asserts);
  * one MoE layer on its own: output, aux, the input's gradient, and
    each rank's top-k picks exactly;

all at rtol 1e-4 / atol 1e-5.  Also: `convert.fit_global` 1x1 -> 2x2
against the reference's fit (`test_system.py`'s `remap_mamba`) bit for
bit, and its loss within that test's bound of the 1x1 loss; the launcher's
gathered global tree through tuple-axis specs; the decode paths at tp >
1 with a sequence-sharded cache against the unsharded decode (tp > 1
itself is served since slice 5c-3a: tests/test_torch_serve_tp.py); the
port's train launcher at --data 2
--model 2 --smoke for granite-moe and zamba2 against the reference's,
loss for loss.  The reference runs in a subprocess with 4 host devices
and hands its numbers over as .npz."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import build
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import convert, transformer

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["granite-moe-3b-a800m", "mamba2-2.7b", "zamba2-1.2b",
         "deepseek-v3-671b"]
MOE = ("granite-moe-3b-a800m", "deepseek-v3-671b")
EPD = "deepseek-v3-671b"          # run with ep_over_data=True
MESHES = [(2, 2), (1, 4), (2, 1)]
CASES = [(a, d) for d in MESHES[:2] for a in ARCHS] + [(EPD, (2, 1))]
IDS = [f"{a}-{d[0]}x{d[1]}" for a, d in CASES]
FIT = ARCHS                       # fit_global 1x1 -> 2x2
LAUNCH = ["granite-moe-3b-a800m", "zamba2-1.2b"]
TOL = dict(rtol=1e-4, atol=1e-5)
# AdamW's eps in the train-step cases, on both sides.  At the default
# 1e-8 the first update is lr x sign(g) wherever |g| >> 1e-8, so an
# element whose gradient is f32 noise around zero (an expert few tokens
# reach) moves by +-lr in two correct runs alike; at 1e-3 the update is
# smooth in g.  The gradients themselves are held at TOL.
STEP_EPS = 1e-3
SLOT = 1 << 16                    # heap slot bytes: payloads cross in chunks

REF_SCRIPT = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
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

    def cfg_of(arch):
        cfg = smoke_config(arch, dtype=jnp.float32, moment_dtype="f32")
        if arch == EPD:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, ep_over_data=True))
        return cfg

    def put(mesh, tree, specs):
        return jax.tree.map(lambda a, s: jax.device_put(
            jnp.asarray(a), NamedSharding(mesh, s)), tree, specs)

    inputs = dict(np.load(sys.argv[2]))
    STACK = P(("data", "model"))
    for arch, dims in CASES:
        cfg = cfg_of(arch)
        tag = f"{arch}/{dims[0]}x{dims[1]}"
        mesh = make_mesh(*dims)
        with jax.set_mesh(mesh):
            shapes, specs = build.abstract_params(cfg, mesh)
            gp = unflat(tag + "/params")
            params = put(mesh, gp, specs)
            batch = unflat(tag + "/batch")
            bspec = {k: P("data", None) for k in batch}
            axes = AxisSpec()
            stacked = jax.tree.map(lambda _: STACK, specs)

            def grad_fn(p, bt):
                comm = Comm(axes, "shmem")
                l, g = jax.value_and_grad(lambda q: transformer.train_loss(
                    comm, cfg, q, bt))(p)
                l = comm.allreduce(l, "data") / comm.axis_size("data")
                g = tstep.fused_grad_sync(
                    comm, g, sharding.needs_data_sync(cfg, shapes))
                return l[None], jax.tree.map(lambda x: x[None], g)

            def step_fn(p, bt):
                ocfg = opt.AdamWConfig(eps=STEP_EPS)
                st = tstep.build_train_step(cfg, axes, "shmem", adamw=ocfg)
                loss, new, _ = st(p, opt.init_state(p, ocfg), bt)
                return loss[None], jax.tree.map(lambda x: x[None], new)

            run = lambda fn, args, i, o: jax.jit(build.shard_mapped(
                fn, mesh, i, o))(*args)
            loss, grads = run(grad_fn, (params, batch), (specs, bspec),
                              (STACK, stacked))
            flat({"loss": loss}, tag)
            flat(grads, tag + "/grads")
            loss, new = run(step_fn, (params, batch), (specs, bspec),
                            (STACK, stacked))
            flat({"loss": loss}, tag + "/step")
            flat(new, tag + "/step/params")
            if arch not in MOE:
                continue
            mspecs = jax.tree.map(lambda s: P(*tuple(s)[1:]),
                                  specs["layers"]["moe"])
            mp = put(mesh, jax.tree.map(lambda a: a[0], gp["layers"]["moe"]),
                     mspecs)
            x, w = (jnp.asarray(inputs[f"{tag}/moe/{k}"]) for k in "xw")

            def moe_fn(p, x, w):
                comm = Comm(axes, "shmem")

                def f(xx):
                    o, aux = L.moe(comm, cfg, p, xx)
                    return jnp.sum(w * o) + aux, (o, aux)
                (_, (o, aux)), gx = jax.value_and_grad(f, has_aux=True)(x)
                tp = comm.axis_size("model")
                flat_x = x.reshape(-1, x.shape[-1])
                t_local = flat_x.shape[0] // tp
                xs = lax.dynamic_slice_in_dim(
                    flat_x, comm.axis_index("model") * t_local, t_local, 0)
                gates = jax.nn.softmax(
                    L._dense(xs, p["router"]).astype(jnp.float32), -1)
                _, tope = lax.top_k(gates, cfg.moe.top_k)
                return o[None], aux[None], gx[None], tope[None]

            res = run(moe_fn, (mp, x, w), (mspecs, P(), P()), (STACK,) * 4)
            flat(dict(zip(("out", "aux", "gx", "tope"), res)), tag + "/moe")

    # fit_global's counterpart: test_system.py's fit and remap_mamba
    def fit(a, t):
        a = np.asarray(a)
        for ax in range(a.ndim):
            s_have, s_want = a.shape[ax], t.shape[ax]
            if s_have == s_want: continue
            if s_have < s_want:
                reps = [1]*a.ndim; reps[ax] = -(-s_want//s_have)
                a = np.tile(a, reps)
            a = np.take(a, range(s_want), axis=ax)
        return a

    for arch in FIT:
        cfg = cfg_of(arch)
        mesh = make_mesh(2, 2)
        with jax.set_mesh(mesh):
            shapes, specs = build.abstract_params(cfg, mesh)
            gshapes = build.global_shape(shapes, specs, mesh)

            def remap_mamba(kp, a, t):
                name = str(getattr(kp[-1], "key", kp[-1]))
                if not any(str(getattr(k, "key", k)) == "mamba"
                           for k in kp):
                    return fit(a, t)
                ss = cfg.ssm
                d_in = ss.expand * cfg.d_model
                gdim = ss.n_groups * ss.state
                nh = d_in // ss.head_dim
                tp = 2
                a = np.asarray(a)
                def split_cols(mat, axis):
                    z = np.split(mat.take(range(0, d_in), axis), tp, axis)
                    x = np.split(mat.take(range(d_in, 2*d_in), axis),
                                 tp, axis)
                    bc = mat.take(range(2*d_in, 2*d_in+2*gdim), axis)
                    dt = np.split(mat.take(
                        range(2*d_in+2*gdim, 2*d_in+2*gdim+nh), axis),
                        tp, axis)
                    return np.concatenate(
                        [np.concatenate([z[i], x[i], bc, dt[i]], axis)
                         for i in range(tp)], axis)
                def split_conv(mat, axis):
                    x = np.split(mat.take(range(0, d_in), axis), tp, axis)
                    bc = mat.take(range(d_in, d_in+2*gdim), axis)
                    return np.concatenate(
                        [np.concatenate([x[i], bc], axis)
                         for i in range(tp)], axis)
                if name == "w_in":
                    return split_cols(a, 2)
                if name in ("conv_w", "conv_b"):
                    return split_conv(a, a.ndim - 1)
                return fit(a, t)
            gp = jax.tree_util.tree_map_with_path(
                remap_mamba, unflat(f"fit/{arch}/params"), gshapes)
            flat(gp, f"fit/{arch}/global")
            batch = unflat(f"fit/{arch}/batch")

            def loss_fn(p, b):
                comm = Comm(AxisSpec(), "shmem")
                l = transformer.train_loss(comm, cfg, p, b)
                return (comm.allreduce(l, "data") / comm.axis_size("data")
                        )[None]
            l2 = jax.jit(build.shard_mapped(
                loss_fn, mesh, (specs, {k: P("data", None) for k in batch}),
                STACK))(put(mesh, gp, specs),
                        jax.tree.map(jnp.asarray, batch))
            flat({"loss": l2}, f"fit/{arch}")
    np.savez(sys.argv[1], **out)
    print("REF-OK")
""")


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], prefix + "/" + k, out)
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            _flat(t, f"{prefix}/{i}", out)
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


def _cfg(arch):
    cfg = smoke_config(arch, dtype=torch.float32, moment_dtype="f32")
    if arch == EPD:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_over_data=True))
    return cfg


def _global_params(arch, dims, seed):
    """Global parameters of a `dims` mesh in the port's layout: the
    port's own 1x1 init fitted to the mesh's layout, with every vector
    (norms, biases, SSM decays and skips: zero or constant at init)
    moved by 0.1 x N(0, 1), so that one cut or laid out wrong shows; the
    weights are random draws already."""
    cfg = _cfg(arch)
    gp = convert.fit_global(transformer.init_params(cfg, seed=seed,
                                                    device="cpu"),
                            cfg, tp=dims[1], dp=dims[0])
    gen = torch.Generator().manual_seed(seed)
    return transformer.map_params(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=gen)
        if t.dim() == 1 else t, gp)


def _tokens(rng, cfg, shape=(4, 16)):
    return {k: rng.integers(1, cfg.vocab, size=shape).astype(np.int32)
            for k in ("tokens", "targets")}


@pytest.fixture(scope="module")
def inputs():
    """Per case: global parameters (port layout), a batch and, for the
    moe family, one MoE layer's input and upstream gradient; per FIT
    arch: 1x1 parameters and a batch."""
    out = {}
    rng = np.random.default_rng(5)
    for i, (arch, dims) in enumerate(CASES):
        cfg = _cfg(arch)
        moe = {k: rng.standard_normal((2, 16, cfg.d_model)).astype(
            np.float32) for k in "xw"} if arch in MOE else {}
        out[f"{arch}/{dims[0]}x{dims[1]}"] = (
            _global_params(arch, dims, 10 + i), _tokens(rng, cfg), moe)
    for i, arch in enumerate(FIT):
        cfg = _cfg(arch)
        out[f"fit/{arch}"] = (transformer.init_params(cfg, seed=30 + i,
                                                      device="cpu"),
                              _tokens(rng, cfg))
    return out


@pytest.fixture(scope="module")
def ref_run(inputs, tmp_path_factory):
    """The reference's subprocesses (the shard_map cases, and the train
    launcher), started on the same inputs and left to run while the
    port's ranks run."""
    d = tmp_path_factory.mktemp("ep")
    arrs = {}
    for tag, (gp, batch, *moe) in inputs.items():
        cfg = _cfg(tag.split("/")[-1] if tag.startswith("fit/")
                   else tag.split("/")[0])
        _flat(convert.params_to_jax(gp, cfg), tag + "/params", arrs)
        _flat(batch, tag + "/batch", arrs)
        if moe and moe[0]:
            _flat(moe[0], tag + "/moe", arrs)
    np.savez(d / "inputs.npz", **arrs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    script = (f"CASES = {CASES!r}\nMOE = {MOE!r}\nEPD = {EPD!r}\n"
              f"FIT = {FIT!r}\nSTEP_EPS = {STEP_EPS!r}\n" + REF_SCRIPT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(d / "ref.npz"),
         str(d / "inputs.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), subprocess.Popen(
        [sys.executable, "-c", LAUNCH_REF, str(d / "launch.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    yield procs, d
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_run, port):
    (proc, _), d = ref_run
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0 and "REF-OK" in out, err[-4000:]
    return dict(np.load(d / "ref.npz"))


def rank_body(cases, fits):
    """One rank: each case of `cases`, then the loss of each fitted
    tree of `fits`."""
    return ([_rank_case(*c) for c in cases],
            [_fit_loss(*f) for f in fits])


def _rank_case(arch, params, batch, moe, gp):
    from repro_torch.core import spmd
    from repro_torch.launch import train as train_mod
    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding
    from repro_torch.parallel.comm import AxisSpec, Comm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as tstep
    cfg = _cfg(arch)
    mesh = spmd.current().mesh
    local = {k: torch.as_tensor(v).long()
             for k, v in build.local_batch(cfg, batch, mesh).items()}
    comm = Comm(AxisSpec())
    loss, grads = tstep.loss_and_grads(comm, cfg, params, local)
    loss = comm.allreduce(loss, "data") / comm.axis_size("data")
    mask = sharding.needs_data_sync(cfg, grads)
    grads = tstep.fused_grad_sync(comm, grads, mask)
    out = {"loss": float(loss), "grads": grads}
    ocfg = opt.AdamWConfig(eps=STEP_EPS)
    step, (_, specs), _ = build.make_train_step(cfg, mesh, adamw=ocfg)
    l, new, _ = step(params, opt.init_state(params, ocfg), batch)
    out["step"] = (float(l), new)
    fused, _, _ = build.make_train_step(cfg, mesh, grad_rs="fused",
                                        adamw=ocfg)
    try:
        out["fused"] = fused(params, tstep.init_fused_opt_state(
            params, mesh.sizes["data"]), batch)[1]
    except ValueError as e:
        out["fused"] = str(e)
    if gp is not None:      # the launcher's gather of the global tree
        out["gathered"] = train_mod._gather_global(comm, specs, params)
    if moe:
        p = params["layers"][0]["moe"]
        x = torch.as_tensor(moe["x"]).requires_grad_()
        o, aux = L.moe(comm, cfg, p, x)
        (torch.as_tensor(moe["w"]) * o).sum().add(aux).backward()
        _, _, tope, _, _, _ = L.moe_route(cfg, p, L.moe_tokens(comm,
                                                               x.detach()))
        out["moe"] = {"out": o.detach(), "aux": aux.detach(), "gx": x.grad,
                      "tope": tope}
    if mesh.sizes["model"] > 1:       # a sequence-sharded decode cache
        out["decode"] = _seq_sharded_decode(comm, cfg, params,
                                            mesh.sizes["model"])
    return out


def _seq_sharded_decode(comm, cfg, params, tp, shards=2, steps=4):
    """At tp > 1: `init_cache` with seq_shards 2 (8 slots), the slots of
    its attention caches; for a GQA attention, `attention_decode` of the
    first attention layer with seq_shards 2 against it and unsharded
    against an 8-slot cache, at positions 0-3 (rows of shard 0; on 2x2
    shard 1 holds rows 4-7 and writes none), each step's output."""
    from repro_torch.models import layers as L
    caches = [transformer.init_cache(cfg, tp, 1, 8, s, device="cpu")
              for s in (shards, 1)]
    out = {"S": sorted({c[k].shape[1] for group in caches[0].values()
                        for c in group for k in ("k", "c_kv") if k in c}),
           "steps": []}
    attn = params.get("shared_attn", params["layers"][0]).get("attn")
    if cfg.attn != "gqa" or attn is None:
        return out
    group = "shared" if "shared" in caches[0] else "layers"
    layer = [c[group][0] for c in caches]
    gen = torch.Generator().manual_seed(5)
    xs = torch.randn(steps, 1, 1, cfg.d_model, generator=gen)
    with torch.no_grad():
        for t in range(steps):
            out["steps"].append([L.attention_decode(
                comm, cfg, attn, xs[t], c, torch.tensor([t]),
                seq_shards=n)[0] for c, n in zip(layer, (shards, 1))])
    return out


def _fit_loss(arch, params, batch):
    from repro_torch.core import spmd
    from repro_torch.parallel.comm import AxisSpec, Comm
    cfg = _cfg(arch)
    mesh = spmd.current().mesh
    local = {k: torch.as_tensor(v).long()
             for k, v in build.local_batch(cfg, batch, mesh).items()}
    comm = Comm(AxisSpec())
    with torch.no_grad():
        loss = transformer.train_loss(comm, cfg, params, local)
    return float(comm.allreduce(loss, "data") / comm.axis_size("data"))


def _fitted(inputs, arch):
    p1, _ = inputs[f"fit/{arch}"]
    return convert.fit_global(p1, _cfg(arch), tp=2, dp=2)


@pytest.fixture(scope="module")
def port(inputs, ref_run):
    """Every rank's results, one rank run per mesh, from the inputs in
    the reference's layout carried over by `convert.shards_from_jax`;
    the 2x2 run also evaluates the fitted 1x1 trees."""
    out = {}
    for dims in MESHES:
        cases = [(a, d) for a, d in CASES if d == dims]
        n = dims[0] * dims[1]
        args = []
        for r in range(n):
            mesh = RankMesh(("data", "model"), dims, r)
            rc = []
            for arch, _ in cases:
                cfg = _cfg(arch)
                gp, batch, moe = inputs[f"{arch}/{dims[0]}x{dims[1]}"]
                rc.append((arch, convert.shards_from_jax(
                    convert.params_to_jax(gp, cfg), cfg, mesh), batch, moe,
                    gp if arch == EPD else None))
            fits = [(a, convert.local_shards(_fitted(inputs, a), _cfg(a),
                                             mesh), inputs[f"fit/{a}"][1])
                    for a in FIT] if dims == (2, 2) else []
            args.append((rc, fits))
        res = build.shard_mapped(rank_body, dims, args, device="cpu",
                                 slot_bytes=SLOT)
        for i, (arch, _) in enumerate(cases):
            out[f"{arch}/{dims[0]}x{dims[1]}"] = [r[0][i] for r in res]
        if dims == (2, 2):
            out["fit"] = {a: [r[1][i] for r in res]
                          for i, a in enumerate(FIT)}
    return out


def _per_rank(ref, key, n):
    """The reference's per-device stacked leaves as one numpy tree per
    rank."""
    flat = _flat(_unflat(ref, key), "", {})
    return [{k: v[r] for k, v in flat.items()} for r in range(n)]


def _port_flat(tree, cfg):
    return _flat(convert.params_to_jax(tree, cfg), "", {})


def _tag(arch, dims):
    return f"{arch}/{dims[0]}x{dims[1]}"


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_loss_matches_reference_shard_map(ref, port, arch, dims):
    """Each rank's loss against its device's: with MoE layers the ranks
    of one data row differ by their own aux losses."""
    tag = _tag(arch, dims)
    want = ref[f"{tag}/loss"]
    got = [res["loss"] for res in port[tag]]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_every_gradient_leaf_matches_reference(ref, port, arch, dims):
    """Every leaf of every rank after the sync: the data-replicated ones
    averaged over `data`, the expert leaves under `ep_over_data` as
    they arrive (sharded over data, not divided by its size)."""
    tag = _tag(arch, dims)
    n = dims[0] * dims[1]
    want = _per_rank(ref, tag + "/grads", n)
    for r, res in enumerate(port[tag]):
        got = _port_flat(res["grads"], _cfg(arch))
        assert sorted(got) == sorted(want[r])
        for k in got:
            np.testing.assert_allclose(got[k], want[r][k],
                                       err_msg=f"rank {r} {k}", **TOL)


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_train_step_matches_reference(ref, port, arch, dims):
    tag = _tag(arch, dims)
    n = dims[0] * dims[1]
    want = _per_rank(ref, tag + "/step/params", n)
    for r, res in enumerate(port[tag]):
        loss, new = res["step"]
        np.testing.assert_allclose(loss, ref[f"{tag}/step/loss"][r], **TOL)
        got = _port_flat(new, _cfg(arch))
        for k in got:
            np.testing.assert_allclose(got[k], want[r][k],
                                       err_msg=f"rank {r} {k}", **TOL)


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_fused_step_equals_default_or_raises_under_ep_over_data(
        port, arch, dims):
    """grad_rs="fused" needs every leaf data-replicated: under
    `ep_over_data` it raises (the reference asserts it); elsewhere its
    step equals the default one at f32 rounding."""
    for r, res in enumerate(port[_tag(arch, dims)]):
        if arch == EPD:
            assert "data-replicated" in res["fused"]
            continue
        got, want = (_port_flat(t, _cfg(arch))
                     for t in (res["fused"], res["step"][1]))
        for k in got:
            np.testing.assert_allclose(got[k], want[k],
                                       err_msg=f"rank {r} {k}", **TOL)


MOE_CASES = [(a, d) for a, d in CASES if a in MOE]


@pytest.mark.parametrize("arch,dims", MOE_CASES,
                         ids=[f"{a}-{d[0]}x{d[1]}" for a, d in MOE_CASES])
def test_moe_layer_matches_reference(ref, port, arch, dims):
    """One MoE layer at ep > 1 (capacity per rank slice, drops
    included): each rank's output, aux and input gradient at rtol 1e-4 /
    atol 1e-5, and its top-k picks exactly."""
    tag = _tag(arch, dims)
    for r, res in enumerate(port[tag]):
        got = res["moe"]
        for k in ("out", "aux", "gx"):
            np.testing.assert_allclose(got[k].numpy(),
                                       ref[f"{tag}/moe/{k}"][r],
                                       err_msg=f"rank {r} {k}", **TOL)
        np.testing.assert_array_equal(got["tope"].numpy(),
                                      ref[f"{tag}/moe/tope"][r])


@pytest.mark.parametrize("arch", FIT)
def test_fit_global_matches_the_reference_fit(ref, inputs, port, arch):
    """The 1x1 tree fitted to 2x2 (Mamba2's column remap, tiled ghost
    slots): bit for bit the reference's fit of the same tree; its 2x2
    loss equals the reference's on that tree, and lies within
    `test_tp2_matches_single_device`'s bound of the 1x1 loss (capacity
    counted per rank slice and Mamba2's per-shard norm keep it from
    equality)."""
    from repro_torch.parallel.comm import Comm
    cfg = _cfg(arch)
    got = _port_flat(_fitted(inputs, arch), cfg)
    want = _flat(_unflat(ref, f"fit/{arch}/global"), "", {})
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    p1, batch = inputs[f"fit/{arch}"]
    with torch.no_grad():
        l1 = float(transformer.train_loss(
            Comm(), cfg, p1, {k: torch.as_tensor(v).long()
                              for k, v in batch.items()}))
    l2 = port["fit"][arch]
    np.testing.assert_allclose(l2, ref[f"fit/{arch}/loss"], **TOL)
    assert all(abs(l1 - l) < 0.05 * max(1.0, abs(l1)) for l in l2)


def test_launcher_gathers_tuple_axis_specs(inputs, port):
    """The launcher's checkpoint gather (`train._gather_global`) on the
    2x2 and 1x4 meshes, experts sharded over (data, model): every rank
    gets the global tree back bit for bit."""
    cfg = _cfg(EPD)
    for dims in MESHES[:2]:
        tag = _tag(EPD, dims)
        want = _port_flat(inputs[tag][0], cfg)
        for r, res in enumerate(port[tag]):
            got = _port_flat(res["gathered"], cfg)
            assert sorted(got) == sorted(want)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"rank {r} {k}")


def test_decode_paths_at_tp_over_one_name_their_slice(port):
    """At tp > 1 (slice 5c-3a, tests/test_torch_serve_tp.py) the
    sequence-sharded cache runs too: `init_cache` with seq_shards 2
    holds 4 of 8 slots a layer (MLA's latent cache too, as the
    reference's), none for mamba2; `attention_decode` with seq_shards 2
    equals the unsharded decode at rtol 1e-4 / atol 1e-5 at every step
    on every rank, its softmax statistics combined over the data axis
    (2 PEs on 2x2, 1 on 1x4)."""
    for (arch, dims) in CASES:
        if dims[1] == 1:
            continue
        cfg = _cfg(arch)
        for r, res in enumerate(port[_tag(arch, dims)]):
            dec = res["decode"]
            assert dec["S"] == ([] if cfg.family == "ssm" else [4]), \
                (arch, dims, dec["S"])
            assert len(dec["steps"]) == (4 if cfg.attn == "gqa"
                                         and cfg.family != "ssm" else 0)
            for t, (sharded, whole) in enumerate(dec["steps"]):
                np.testing.assert_allclose(
                    sharded.numpy(), whole.numpy(),
                    err_msg=f"{arch} {dims} rank {r} step {t}", **TOL)


def test_fused_sync_raises_under_ep_over_data():
    """`fused_adam_sync` refuses a tree whose expert leaves are sharded
    over `data`, on one device too; without `ep_over_data` the same tree
    passes the check."""
    from repro_torch.parallel import sharding
    from repro_torch.parallel.comm import Comm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as tstep
    cfg = _cfg(EPD)
    params = transformer.init_params(cfg, device="cpu")
    mask = sharding.needs_data_sync(cfg, params)
    flags = _flat(transformer.map_params(
        lambda t: np.asarray(t), mask), "", {})
    assert {k for k, v in flags.items() if not v} == {
        f"/layers/{i}/moe/{w}" for i in range(len(params["layers"]))
        for w in ("w_gate", "w_up", "w_down")}
    grads = transformer.map_params(torch.zeros_like, params)
    with pytest.raises(ValueError, match="data-replicated"):
        tstep.fused_adam_sync(Comm(), params, grads,
                              tstep.init_fused_opt_state(params),
                              opt.AdamWConfig(), mask)
    plain = _cfg("granite-moe-3b-a800m")
    p2 = transformer.init_params(plain, device="cpu")
    assert all(_flat(transformer.map_params(
        np.asarray, sharding.needs_data_sync(plain, p2)), "", {}).values())


LAUNCH_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.configs import smoke_config
    from repro.launch import build
    from repro.launch import train as train_mod
    from repro.launch.mesh import make_mesh
    out = {}

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                flat(tree[k], prefix + "/" + k)
        else:
            out[prefix] = np.asarray(tree)

    for arch in %r:
        mesh = make_mesh(2, 2)
        with jax.set_mesh(mesh):       # the launcher's own seed-0 init
            init_fn, _, _ = build.make_init_fn(smoke_config(arch), mesh)
            flat(jax.jit(init_fn)(jax.random.key(0)), arch + "/params")
        out[arch + "/losses"] = np.asarray(train_mod.main(
            ["--arch", arch] + %r))
    np.savez(sys.argv[1], **out)
    print("LAUNCH-OK")
""")
LAUNCH_ARGV = ["--smoke", "--seq-len", "16", "--batch", "4", "--steps", "3",
               "--data", "2", "--model", "2"]
LAUNCH_REF = LAUNCH_REF % (LAUNCH, LAUNCH_ARGV)


@pytest.mark.parametrize("arch", LAUNCH)
def test_launcher_2x2_matches_reference_launcher(ref_run, arch):
    """`launch.train --data 2 --model 2 --smoke` against the reference's
    launcher with the same flags, loss for loss, both from the
    reference launcher's seed-0 global parameters (handed to the port's
    `train.run(params=)`): bf16 compute, so within 2e-3."""
    (_, proc), d = ref_run
    if proc.returncode is None:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "LAUNCH-OK" in out, err[-3000:]
    ref = dict(np.load(d / "launch.npz"))
    from repro_torch.launch import train as train_mod
    cfg = smoke_config(arch)
    params = convert.params_from_jax(_unflat(ref, arch + "/params"), cfg)
    got = train_mod.run(["--arch", arch, "--device", "cpu"] + LAUNCH_ARGV,
                        params=params).losses
    assert len(got) == 3
    np.testing.assert_allclose(got, ref[arch + "/losses"], rtol=2e-3)


def test_in_place_adamw_equals_the_functional_step():
    """`apply_updates(inplace=True)` (f32 moments) gives the functional
    step's parameters and moments bit for bit, in the storage it was
    given, for f32 and bf16 parameters, two steps running; `init_state`
    gives m and v storage of their own."""
    from repro_torch.core.heap import tree_flatten
    from repro_torch.train import optimizer as opt
    gen = torch.Generator().manual_seed(9)
    cfg = opt.AdamWConfig()
    for dt in (torch.float32, torch.bfloat16):
        params = {"w": torch.randn(6, 5, generator=gen).to(dt),
                  "b": torch.randn(5, generator=gen)}
        grads = [transformer.map_params(
            lambda t: torch.randn(t.shape, generator=gen), params)
            for _ in range(2)]
        ref_p, ref_s = params, opt.init_state(params, cfg)
        own = transformer.map_params(torch.clone, params)
        own_s = opt.init_state(own, cfg)
        for mv in own_s["mv"]:
            assert mv["m"].data_ptr() != mv["v"].data_ptr()
        ptrs = [t.data_ptr() for t in tree_flatten(own)[0]]
        for g in grads:
            ref_p, ref_s = opt.apply_updates(ref_p, g, ref_s, cfg)
            own, own_s = opt.apply_updates(own, g, own_s, cfg, inplace=True)
        assert [t.data_ptr() for t in tree_flatten(own)[0]] == ptrs
        for a, b in zip(tree_flatten(own)[0], tree_flatten(ref_p)[0]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(own_s["mv"], ref_s["mv"]):
            assert torch.equal(a["m"], b["m"]) and torch.equal(a["v"], b["v"])


def test_launcher_on_its_own_init_updates_in_place_and_equals():
    """The train launcher on 1x4 from its ranks' own seed-0 init (the
    donated, in-place step) gives the losses of the same run handed the
    global tree of that init (the functional step), bit for bit: every
    rank draws the same local tree, so that global tree is it tiled
    along each sharded dim (`convert.global_params`)."""
    from repro_torch.launch import train as train_mod
    arch = "granite-moe-3b-a800m"
    cfg = smoke_config(arch)
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--seq-len", "16",
            "--batch", "4", "--steps", "3", "--data", "1", "--model", "4"]
    local = transformer.init_params(cfg, seed=0, device="cpu", tp=4)
    gp = convert.global_params([local] * 4, cfg, (1, 4))
    own = train_mod.run(argv).losses
    handed = train_mod.run(argv, params=gp).losses
    assert len(own) == 3 and own == handed
