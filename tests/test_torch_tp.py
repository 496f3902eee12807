"""Tensor and data parallelism on the rank mesh against the reference's
shard_map, on the CPU: a smoke qwen2 (ghost heads and replicated KV on
both meshes) and a smoke gemma2 (local/global layers, softcaps), each on
a 2x2 (data x model) and a 1x4 mesh of rank processes (gloo, a
shared-memory heap), from the same global parameters carried over by
`models.convert.shards_from_jax`, in f32 compute:

  * the loss (the data-axis mean) against the reference's `train_loss`
    in shard_map;
  * every gradient leaf of every rank after the data-axis sync against
    that device's in the reference;
  * one `build_train_step` step, default and fused sync: the loss and
    every rank's new parameters;

all at rtol 1e-4 / atol 1e-5.  Then the port's train launcher at
--data 2 --model 2 --smoke against the reference's launcher, loss for
loss (from the same global parameters), and the port's 1x1 parameters
fitted to the 2x2 layout against the 1x1 loss
(`test_system.py::test_tp2_matches_single_device`'s bound).  The
reference runs in a subprocess with 4 host devices and hands its numbers
over as .npz."""
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
ARCHS = ["qwen2-0.5b", "gemma2-9b"]
MESHES = [(2, 2), (1, 4)]
TOL = dict(rtol=1e-4, atol=1e-5)
CASES = [(a, d) for a in ARCHS for d in MESHES]
IDS = [f"{a}-{d[0]}x{d[1]}" for a, d in CASES]
SLOT = 1 << 16            # heap slot bytes: payloads cross in many chunks

REF_SCRIPT = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import smoke_config
    from repro.launch import build
    from repro.launch.mesh import make_mesh
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

    inputs = dict(np.load(sys.argv[2]))
    STACK = P(("data", "model"))
    for arch in ARCHS:
        cfg = smoke_config(arch, dtype=jnp.float32, moment_dtype="f32")
        for dims in MESHES:
            tag = f"{arch}/{dims[0]}x{dims[1]}"
            mesh = make_mesh(*dims)
            with jax.set_mesh(mesh):
                shapes, specs = build.abstract_params(cfg, mesh)
                gp = unflat(tag + "/params")
                params = jax.tree.map(lambda a, s: jax.device_put(
                    jnp.asarray(a), NamedSharding(mesh, s)), gp, specs)
                batch = unflat(tag + "/batch")
                bspec = {k: P("data", None) for k in batch}
                axes = AxisSpec()

                def grad_fn(p, bt):
                    comm = Comm(axes, "shmem")
                    l, g = jax.value_and_grad(lambda q: transformer.train_loss(
                        comm, cfg, q, bt))(p)
                    l = comm.allreduce(l, "data") / comm.axis_size("data")
                    g = tstep.fused_grad_sync(
                        comm, g, sharding.needs_data_sync(cfg, shapes))
                    return l, jax.tree.map(lambda x: x[None], g)

                def step_fn(rs):
                    def f(p, bt):
                        st = tstep.build_train_step(cfg, axes, "shmem",
                                                    grad_rs=rs)
                        s0 = (tstep.init_fused_opt_state(p, dims[0])
                              if rs == "fused" else opt.init_state(
                                  p, opt.AdamWConfig()))
                        loss, new, _ = st(p, s0, bt)
                        return loss, jax.tree.map(lambda x: x[None], new)
                    return f

                run = lambda fn, o: jax.jit(build.shard_mapped(
                    fn, mesh, (specs, bspec), o))(params, batch)
                loss, grads = run(grad_fn, (P(), jax.tree.map(
                    lambda _: STACK, specs)))
                flat({"loss": loss}, tag)
                flat(grads, tag + "/grads")
                for rs in (False, "fused"):
                    loss, new = run(step_fn(rs), (P(), jax.tree.map(
                        lambda _: STACK, specs)))
                    flat({"loss": loss}, f"{tag}/step_{rs}")
                    flat(new, f"{tag}/step_{rs}/params")
    np.savez(sys.argv[1], **out)
    print("REF-OK")
""")


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


def _cfg(arch):
    return smoke_config(arch, dtype=torch.float32, moment_dtype="f32")


def _global_params(arch, dims, seed):
    """Global parameters of a `dims` mesh in the port's layout: the
    port's own 1x1 init fitted to the mesh's layout, every leaf moved
    off it (so norms and biases are nonzero)."""
    cfg = _cfg(arch)
    gp = convert.fit_global(transformer.init_params(cfg, seed=seed,
                                                    device="cpu"),
                            cfg, tp=dims[1], dp=dims[0])
    gen = torch.Generator().manual_seed(seed)
    return transformer.map_params(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=gen), gp)


@pytest.fixture(scope="module")
def inputs():
    """Per (arch, mesh): global parameters (port layout) and a batch."""
    out = {}
    rng = np.random.default_rng(2)
    for i, (arch, dims) in enumerate(CASES):
        batch = {k: rng.integers(1, _cfg(arch).vocab, size=(4, 16)).astype(
            np.int32) for k in ("tokens", "targets")}
        out[f"{arch}/{dims[0]}x{dims[1]}"] = (_global_params(arch, dims, i),
                                             batch)
    return out


@pytest.fixture(scope="module")
def ref_run(inputs, tmp_path_factory):
    """The reference's subprocess, started on the same inputs (in its
    layout) and left to run while the port's ranks run."""
    d = tmp_path_factory.mktemp("tp")
    arrs = {}
    for tag, (gp, batch) in inputs.items():
        arch = tag.split("/")[0]
        _flat(convert.params_to_jax(gp, _cfg(arch)), tag + "/params", arrs)
        _flat(batch, tag + "/batch", arrs)
    np.savez(d / "inputs.npz", **arrs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    script = f"ARCHS = {ARCHS!r}\nMESHES = {MESHES!r}\n" + REF_SCRIPT
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(d / "ref.npz"),
         str(d / "inputs.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), subprocess.Popen(
        [sys.executable, "-c", LAUNCH_REF, str(d / "launch.npz")]
        + LAUNCH_ARGV + ["--steps", "4", "--data", "2", "--model", "2"],
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


def rank_body(cases):
    """One rank, for each (arch, local shards, batch) of `cases`: the
    loss, the synced gradients and a default and a fused step from the
    same local shards."""
    return [_rank_case(*c) for c in cases]


def _rank_case(arch, params, batch):
    from repro_torch.core import spmd
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
    grads = tstep.fused_grad_sync(comm, grads,
                                  sharding.needs_data_sync(cfg, grads))
    out = {"loss": float(loss), "grads": grads}
    for rs in (False, "fused"):
        step, _, ocfg = build.make_train_step(cfg, mesh, grad_rs=rs)
        state = (tstep.init_fused_opt_state(params, mesh.sizes["data"])
                 if rs == "fused" else opt.init_state(params, ocfg))
        l, new, _ = step(params, state, batch)
        out[f"step_{rs}"] = (float(l), new)
    return out


@pytest.fixture(scope="module")
def port(inputs, ref_run):
    """Every rank's results, one rank run per mesh (both archs), from
    the inputs in the reference's layout carried over by
    `convert.shards_from_jax`."""
    out = {}
    for dims in MESHES:
        tags = [f"{a}/{dims[0]}x{dims[1]}" for a in ARCHS]
        args = []
        for r in range(4):
            mesh = RankMesh(("data", "model"), dims, r)
            cases = []
            for arch, tag in zip(ARCHS, tags):
                cfg = _cfg(arch)
                gp, batch = inputs[tag]
                cases.append((arch, convert.shards_from_jax(
                    convert.params_to_jax(gp, cfg), cfg, mesh), batch))
            args.append((cases,))
        res = build.shard_mapped(rank_body, dims, args, device="cpu",
                                 slot_bytes=SLOT)
        for i, tag in enumerate(tags):
            out[tag] = [r[i] for r in res]
    return out


def _per_rank(ref, key, n=4):
    """The reference's per-device stacked leaves as one numpy tree per
    rank."""
    tree = _unflat(ref, key)
    flat = _flat(tree, "", {})
    return [{k: v[r] for k, v in flat.items()} for r in range(n)]


def _port_flat(tree, cfg):
    return _flat(convert.params_to_jax(tree, cfg), "", {})


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_loss_matches_reference_shard_map(ref, port, arch, dims):
    tag = f"{arch}/{dims[0]}x{dims[1]}"
    for r, res in enumerate(port[tag]):
        np.testing.assert_allclose(res["loss"], ref[f"{tag}/loss"],
                                   err_msg=f"rank {r}", **TOL)


@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_every_synced_gradient_leaf_matches_reference(ref, port, arch,
                                                      dims):
    tag = f"{arch}/{dims[0]}x{dims[1]}"
    want = _per_rank(ref, tag + "/grads")
    for r, res in enumerate(port[tag]):
        got = _port_flat(res["grads"], _cfg(arch))
        assert sorted(got) == sorted(want[r])
        for k in got:
            np.testing.assert_allclose(got[k], want[r][k],
                                       err_msg=f"rank {r} {k}", **TOL)


@pytest.mark.parametrize("grad_rs", [False, "fused"])
@pytest.mark.parametrize("arch,dims", CASES, ids=IDS)
def test_train_step_matches_reference(ref, port, arch, dims, grad_rs):
    tag = f"{arch}/{dims[0]}x{dims[1]}"
    want = _per_rank(ref, f"{tag}/step_{grad_rs}/params")
    for r, res in enumerate(port[tag]):
        loss, new = res[f"step_{grad_rs}"]
        np.testing.assert_allclose(loss, ref[f"{tag}/step_{grad_rs}/loss"],
                                   **TOL)
        got = _port_flat(new, _cfg(arch))
        for k in got:
            np.testing.assert_allclose(got[k], want[r][k],
                                       err_msg=f"rank {r} {k}", **TOL)


def test_global_params_round_trip(inputs):
    """local_shards then global_params give the global tree back, bit for
    bit (ghost-head and replicated-KV leaves included)."""
    cfg = _cfg("qwen2-0.5b")
    for dims in MESHES:
        gp = inputs[f"qwen2-0.5b/{dims[0]}x{dims[1]}"][0]
        shards = [convert.local_shards(gp, cfg, RankMesh(
            ("data", "model"), dims, r)) for r in range(4)]
        back = convert.global_params(shards, cfg, dims)
        a, b = _port_flat(gp, cfg), _port_flat(back, cfg)
        mesh = build.mesh_of(*dims)      # the global shapes, from specs
        shapes = _port_flat(transformer.map_params(torch.zeros, build.
            global_shape(*build.abstract_params(cfg, mesh), mesh)), cfg)
        assert {k: v.shape for k, v in shapes.items()} == \
            {k: v.shape for k, v in a.items()}
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def fit_body(params, batch):
    from repro_torch.core import spmd
    from repro_torch.parallel.comm import AxisSpec, Comm
    cfg = _cfg("qwen2-0.5b")
    mesh = spmd.current().mesh
    local = {k: torch.as_tensor(v).long()
             for k, v in build.local_batch(cfg, batch, mesh).items()}
    comm = Comm(AxisSpec())
    with torch.no_grad():
        loss = transformer.train_loss(comm, cfg, params, local)
    return float(comm.allreduce(loss, "data") / comm.axis_size("data"))


def test_fitted_1x1_params_give_the_1x1_loss():
    """The port's own 1x1 parameters, fitted to the 2x2 layout
    (`convert.fit_global`: ghost heads tile-extended), on 4 ranks: the
    loss within the reference's bound of the 1x1 loss, and in fact at
    f32 rounding."""
    from repro_torch.parallel.comm import Comm
    cfg = _cfg("qwen2-0.5b")
    p1 = transformer.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(1, cfg.vocab, size=(4, 16))
             for k in ("tokens", "targets")}
    with torch.no_grad():
        l1 = float(transformer.train_loss(
            Comm(), cfg, p1, {k: torch.as_tensor(v)
                              for k, v in batch.items()}))
    gp = convert.fit_global(p1, cfg, tp=2, dp=2)
    args = [(convert.local_shards(gp, cfg, RankMesh(("data", "model"),
                                                    (2, 2), r)), batch)
            for r in range(4)]
    l2 = build.shard_mapped(fit_body, (2, 2), args, device="cpu",
                            slot_bytes=SLOT)
    assert abs(l1 - l2[0]) < 0.05 * max(1.0, abs(l1))
    np.testing.assert_allclose(l2, l1, **TOL)


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

    mesh = make_mesh(2, 2)
    with jax.set_mesh(mesh):       # the launcher's own seed-0 init
        init_fn, _, _ = build.make_init_fn(smoke_config("qwen2-0.5b"), mesh)
        flat(jax.jit(init_fn)(jax.random.key(0)), "params")
    out["losses"] = np.asarray(train_mod.main(sys.argv[2:]))
    np.savez(sys.argv[1], **out)
    print("LAUNCH-OK")
""")


LAUNCH_ARGV = ["--arch", "qwen2-0.5b", "--smoke", "--seq-len", "16",
               "--batch", "4"]


def test_launcher_2x2_matches_reference_launcher(ref_run, tmp_path):
    """`launch.train --data 2 --model 2 --smoke` against the reference's
    launcher with the same flags, loss for loss, both from the
    reference launcher's seed-0 global parameters (handed to the port's
    `train.run(params=)`): bf16 compute, so within 2e-3.  The port's
    run stops after 3 of the 4 steps with a checkpoint of the GLOBAL
    tree gathered from its ranks, and its 4th step resumes from it on a
    1x2 mesh (the elastic shrink of `test_elastic_shrink_resume`)."""
    argv = LAUNCH_ARGV
    (_, proc), d = ref_run
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "LAUNCH-OK" in out, err[-3000:]
    ref = dict(np.load(d / "launch.npz"))
    from repro_torch.launch import train as train_mod
    cfg = smoke_config("qwen2-0.5b")
    params = convert.params_from_jax(_unflat(ref, "params"), cfg)
    ck = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
          "--ckpt-every", "2"]
    got = train_mod.run(argv + ck + ["--steps", "3", "--data", "2",
                                     "--model", "2"], params=params).losses
    got += train_mod.main(argv + ck + ["--steps", "4", "--data", "1",
                                       "--model", "2", "--resume", "auto"])
    assert len(got) == 4
    np.testing.assert_allclose(got, ref["losses"], rtol=2e-3)
