"""fsdp (ZeRO-3 over `data`), `dp_only`, checkpoints and the engine's
fault drain on the rank mesh against the reference, on the CPU.  The
reference runs in two subprocesses with 4 host devices (shard_map; its
train launcher), started first and left to run while the port's rank
processes run, and hands its numbers over as .npz:

  (a) `param_specs`, the fsdp-localized shapes and `needs_data_sync`
      for every arch's smoke config with fsdp=True at 2x2 and 4x1, leaf
      by leaf (the reference's stacked prefix dropped), and the same
      refusal where a leaf's rows do not split over the data PEs;
  (b) smoke qwen2 with fsdp on 2x2 in f32: the loss, every rank's
      gradient leaf (the fsdp leaves summed over `data`, not synced) and
      one default-sync step, against each device's under shard_map, the
      data-full parameters cut to each rank's rows as the reference's
      `fsdp_shard_init` cuts them;
  (c) smoke deepseek with fsdp, `ep_over_data` and int8 moments on 2x2:
      the same (the step with int8 moments blocked over each rank's
      local leaves), then the train launcher against the reference's
      from its seed-0 init: the losses, every leaf of the saved
      checkpoint (names, shapes, values: a per-layer fsdp leaf holds
      data rank 0's rows, int8 moments rank 0's blocks) and a resume;
  (d) `--shard-strategy dp_only --data 2 --model 2` through the port's
      launcher against the reference's, loss for loss, and one dp_only
      step on every rank against that device's (the model-axis replicas
      take different batch slices and drift apart, as the reference's);
  (e) the tp = 2 kill-and-resume of `test_fault.py::
      test_spmd_tp2_kill_and_resume` through the port's launcher;
  (f) `ckpt.restore(shardings=)` and `elastic.recover(shardings=)`: each
      rank's block bit for bit against each device's of the reference's
      `jax.device_put(arr, NamedSharding)`, a resharded leaf included;
  (g) the paged engine's PE-failure drain on a (1, 2) rank mesh, as
      `test_fault.py::test_serve_pe_failure_drains_requeues_and_
      regenerates_bitwise`: every rank drains alike, and the re-run's
      tokens equal an undisturbed (1, 2) engine's bit for bit.

Also: `Comm.allgather`'s backward sums each block's cotangents over the
PEs that read it (the fsdp gradient), on 2 data PEs.  Float results are
held at rtol 1e-4 / atol 1e-5 (the launcher's bf16 dp_only run at 2e-3,
as `test_torch_tp.py`'s launcher test)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.ckpt import manager as ckpt
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import build
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import convert, transformer
from repro_torch.parallel import sharding

ROOT = os.path.join(os.path.dirname(__file__), "..")
QWEN, DEEP = "qwen2-0.5b", "deepseek-v3-671b"
GRAD_ARCHS = [QWEN, DEEP]
SPEC_MESHES = [(2, 2), (4, 1)]
TOL = dict(rtol=1e-4, atol=1e-5)
# AdamW's eps in deepseek's step case, on both sides, as in
# test_torch_ep.py: at 1e-8 an element whose gradient is f32 noise around
# zero moves by +-lr in two correct runs alike
STEP_EPS = 1e-3
SLOT = 1 << 16                    # heap slot bytes: payloads cross in chunks
DS_ARGV = ["--arch", DEEP, "--smoke", "--data", "2", "--model", "2",
           "--seq-len", "16", "--batch", "4"]
DP_ARGV = ["--arch", QWEN, "--smoke", "--data", "2", "--model", "2",
           "--seq-len", "16", "--batch", "8", "--steps", "3",
           "--shard-strategy", "dp_only"]
KILL_ARGV = ["--arch", QWEN, "--smoke", "--data", "1", "--model", "2",
             "--seq-len", "32", "--batch", "4"]
ENGINE_KW = dict(max_slots=3, page_size=8, max_seq=32, prompt_bucket=16)
# restore(shardings=): name -> (saved shape, template shape, spec)
RESTORE = {"w": ((8, 6), (8, 6), (("model", "data"), None)),
           "v": ((6, 4), (6, 4), (None, "model")),
           "r": ((4, 6), (8, 6), ("data", None)),
           "s": ((5,), (5,), ())}

COMMON = textwrap.dedent("""
    import os, sys, json, dataclasses, shutil
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.configs as C
    from repro.launch import build
    from repro.launch.mesh import make_mesh
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

    def put(mesh, tree, specs):
        return jax.tree.map(lambda a, s: jax.device_put(
            jnp.asarray(a), NamedSharding(mesh, s)), tree, specs)

    STACK = P(("data", "model"))
    real_smoke = C.smoke_config

    def fsdp_cfg(arch):
        cfg = real_smoke(arch, dtype=jnp.float32, moment_dtype="f32",
                         fsdp=True)
        if arch == DEEP:
            cfg = dataclasses.replace(cfg, moment_dtype="int8",
                                      moe=dataclasses.replace(
                                          cfg.moe, ep_over_data=True))
        return cfg
""")

REF_SCRIPT = COMMON + textwrap.dedent("""
    from repro.ckpt import manager as ckpt
    from repro.configs.registry import ARCHS as ALL
    from repro.core import sim_ctx
    from repro.core.elastic import recover
    from repro.models import transformer
    from repro.parallel import sharding
    from repro.parallel.comm import AxisSpec, Comm
    from repro.train import optimizer as opt
    from repro.train import step as tstep

    inputs = dict(np.load(sys.argv[2]))
    doc = {}
    ent = lambda e: list(e) if isinstance(e, tuple) else e
    for arch in sorted(ALL):                                  # (a)
        cfg = dataclasses.replace(real_smoke(arch), fsdp=True)
        for dims in SPEC_MESHES:
            tag = f"{arch}/{dims[0]}x{dims[1]}"
            mesh = make_mesh(*dims)
            try:
                with jax.set_mesh(mesh):
                    shapes, specs = build.abstract_params(cfg, mesh)
                    sync = sharding.needs_data_sync(cfg, shapes)
            except AssertionError:
                doc[tag] = "refused"
                continue
            leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
            sl = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
            doc[tag] = {
                "/".join(str(getattr(k, "key", k)) for k in kp):
                [list(s.shape), [ent(e) for e in sp], bool(y)]
                for (kp, s), sp, y in zip(leaves, sl, jax.tree.leaves(sync))}

    mesh = make_mesh(2, 2)
    for arch in GRAD_ARCHS:                                   # (b), (c)
        cfg = fsdp_cfg(arch)
        plain = dataclasses.replace(cfg, fsdp=False)
        with jax.set_mesh(mesh):
            shapes, _ = build.abstract_params(cfg, mesh)
            _, specs = build.abstract_params(plain, mesh)   # data-full
            params = put(mesh, unflat(arch + "/params"), specs)
            batch = unflat(arch + "/batch")
            bspec = {k: P("data", None) for k in batch}
            stacked = jax.tree.map(lambda _: STACK, specs)
            ocfg = opt.AdamWConfig(moment_dtype=cfg.moment_dtype,
                                   **({"eps": STEP_EPS} if arch == DEEP
                                      else {}))

            def own(p):
                return sharding.fsdp_shard_init(
                    cfg, p, lax.axis_index("data"), 2)

            def grad_fn(p, bt):
                p = own(p)
                comm = Comm(AxisSpec(), "shmem")
                l, g = jax.value_and_grad(lambda q: transformer.train_loss(
                    comm, cfg, q, bt))(p)
                l = comm.allreduce(l, "data") / comm.axis_size("data")
                g = tstep.fused_grad_sync(
                    comm, g, sharding.needs_data_sync(cfg, shapes))
                return l[None], jax.tree.map(lambda x: x[None], g)

            def step_fn(p, bt):
                p = own(p)
                st = tstep.build_train_step(cfg, AxisSpec(), "shmem",
                                            adamw=ocfg)
                loss, new, _ = st(p, opt.init_state(p, ocfg), bt)
                return loss[None], jax.tree.map(lambda x: x[None], new)

            for name, fn in (("grads", grad_fn), ("step", step_fn)):
                loss, tree = jax.jit(build.shard_mapped(
                    fn, mesh, (specs, bspec), (STACK, stacked)))(params,
                                                                 batch)
                flat({"loss": loss}, f"{arch}/{name}")
                flat(tree, f"{arch}/{name}/tree")

    cfg = dataclasses.replace(real_smoke(QWEN, dtype=jnp.float32,  # (d)
                                         moment_dtype="f32"),
                              shard_strategy="dp_only")
    with jax.set_mesh(mesh):
        _, specs = build.abstract_params(cfg, mesh)
        batch = unflat("dp/batch")
        bspec = sharding.batch_specs(cfg, batch, build.mesh_axes(mesh, cfg),
                                     "train")

        def dp_step(p, bt):
            st = tstep.build_train_step(cfg, build.axis_spec(mesh, cfg),
                                        "shmem")
            loss, new, _ = st(p, opt.init_state(p, opt.AdamWConfig()), bt)
            return loss[None], jax.tree.map(lambda x: x[None], new)

        loss, tree = jax.jit(build.shard_mapped(
            dp_step, mesh, (specs, bspec),
            (STACK, jax.tree.map(lambda _: STACK, specs))))(
            put(mesh, unflat("dp/params"), specs), batch)
        flat({"loss": loss}, "dp/step")
        flat(tree, "dp/step/tree")

    d = sys.argv[3]                                           # (f)
    with jax.set_mesh(mesh):
        tmpl = {k: jax.ShapeDtypeStruct(tuple(t), jnp.float32)
                for k, (_, t, _) in RESTORE.items()}
        shd = {k: NamedSharding(mesh, P(*s)) for k, (_, _, s)
               in RESTORE.items()}
        step, got = ckpt.restore(d, tmpl, shardings=shd)
        rstep, rgot, dm = recover(sim_ctx(4), [1], d, tmpl, shd)
        for tag, tree in (("restore", got), ("recover", rgot)):
            for k, arr in tree.items():
                by_dev = {s.device.id: np.asarray(s.data)
                          for s in arr.addressable_shards}
                for r, dev in enumerate(mesh.devices.flat):
                    out[f"{tag}/{k}/{r}"] = by_dev[dev.id]
        out["restore/step"] = np.asarray([step, rstep])
        doc["recover_fingerprint"] = dm.fingerprint
    np.savez(sys.argv[1], **out)
    pathlib_doc = sys.argv[1] + ".json"
    open(pathlib_doc, "w").write(json.dumps(doc))
    print("REF-OK")
""")

LAUNCH_REF = COMMON + textwrap.dedent("""
    import glob
    from repro.launch import train as train_mod

    def patched(arch, **kw):
        return fsdp_cfg(arch) if arch == DEEP else real_smoke(arch, **kw)

    C.smoke_config = patched
    d = sys.argv[2]
    mesh = make_mesh(2, 2)
    with jax.set_mesh(mesh):
        # the data-full seed-0 tree the fsdp init cuts each rank's rows
        # from (the same draws: init_params does not read fsdp)
        init_fn, _, _ = build.make_init_fn(
            dataclasses.replace(fsdp_cfg(DEEP), fsdp=False), mesh)
        flat(jax.jit(init_fn)(jax.random.key(0)), "ds/init")
        init_fn, _, _ = build.make_init_fn(dataclasses.replace(
            real_smoke(QWEN), shard_strategy="dp_only"), mesh)
        flat(jax.jit(init_fn)(jax.random.key(0)), "dp/init")
    out["ds/losses"] = np.asarray(train_mod.main(
        DS_ARGV + ["--steps", "1", "--ckpt-dir", d + "/ds"]))
    step = sorted(glob.glob(d + "/ds/step-*"))[-1]
    for rec in json.load(open(step + "/manifest.json"))["leaves"]:
        out["ds/ckpt/" + rec["name"]] = np.load(step + "/" + rec["file"])
    shutil.copytree(d + "/ds", d + "/ds-resume")
    out["ds/resumed"] = np.asarray(train_mod.main(
        DS_ARGV + ["--steps", "2", "--ckpt-dir", d + "/ds-resume",
                   "--resume", "auto"]))
    out["dp/losses"] = np.asarray(train_mod.main(DP_ARGV))
    np.savez(sys.argv[1], **out)
    print("LAUNCH-OK")
""")


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], prefix + "/" + k, out)
    else:
        out[prefix] = np.asarray(tree)
    return out


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


def _fsdp_cfg(arch):
    """The smoke config of the shard_map and launcher cases: f32 compute,
    fsdp; deepseek with int8 moments and `ep_over_data` (its full
    config's switches)."""
    cfg = smoke_config(arch, dtype=torch.float32, moment_dtype="f32",
                       fsdp=True)
    if arch == DEEP:
        cfg = dataclasses.replace(cfg, moment_dtype="int8",
                                  moe=dataclasses.replace(
                                      cfg.moe, ep_over_data=True))
    return cfg


def _global_params(arch, seed):
    """Data-full global parameters of the 2x2 mesh in the port's layout:
    the port's 1x1 init fitted to 2x2, every vector moved off its init
    by 0.1 x N(0, 1)."""
    cfg = _fsdp_cfg(arch)
    gp = convert.fit_global(transformer.init_params(cfg, seed=seed,
                                                    device="cpu"),
                            cfg, tp=2, dp=2)
    gen = torch.Generator().manual_seed(seed)
    return transformer.map_params(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=gen)
        if t.dim() == 1 else t, gp)


def _ref_path(path, cfg):
    """(the reference's path of a port leaf, whether it is stacked)."""
    if path[0] in ("layers", "dense_layers"):
        head = [path[0]]
        if cfg.local_global_period is not None:
            head = ["pairs", "local" if int(path[1]) % 2 == 0 else "global"]
        return "/".join(head + list(path[2:])), True
    return "/".join(path), False


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    out = {}
    for i, arch in enumerate(GRAD_ARCHS):
        cfg = _fsdp_cfg(arch)
        out[arch] = (_global_params(arch, 20 + i), {
            k: rng.integers(1, cfg.vocab, size=(4, 16)).astype(np.int32)
            for k in ("tokens", "targets")})
    cfg = smoke_config(QWEN, dtype=torch.float32)
    gen = torch.Generator().manual_seed(9)
    out["dp"] = (transformer.map_params(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=gen)
        if t.dim() == 1 else t,
        transformer.init_params(cfg, seed=9, device="cpu")), {
        k: rng.integers(1, cfg.vocab, size=(8, 16)).astype(np.int32)
        for k in ("tokens", "targets")})
    out["restore"] = {k: rng.standard_normal(s).astype(np.float32)
                      for k, (s, _, _) in RESTORE.items()}
    out["prompts"] = [rng.integers(1, 1000, size=n).astype(np.int32)
                      for n in (5, 9, 3, 7)]
    return out


@pytest.fixture(scope="module")
def ref_run(inputs, tmp_path_factory):
    """Both reference subprocesses, started on the inputs (in the
    reference's layout) and left to run while the port's ranks run."""
    d = tmp_path_factory.mktemp("fsdp")
    arrs = {}
    for arch in GRAD_ARCHS:
        gp, batch = inputs[arch]
        _flat(convert.params_to_jax(gp, _fsdp_cfg(arch)), arch + "/params",
              arrs)
        _flat(batch, arch + "/batch", arrs)
    dp, batch = inputs["dp"]
    _flat(convert.params_to_jax(dp, smoke_config(QWEN)), "dp/params", arrs)
    _flat(batch, "dp/batch", arrs)
    np.savez(d / "inputs.npz", **arrs)
    ckpt.save(d / "restore", 5, {k: torch.from_numpy(v) for k, v in
                                 inputs["restore"].items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    head = (f"QWEN, DEEP = {QWEN!r}, {DEEP!r}\nGRAD_ARCHS = {GRAD_ARCHS!r}\n"
            f"SPEC_MESHES = {SPEC_MESHES!r}\nSTEP_EPS = {STEP_EPS!r}\n"
            f"RESTORE = {RESTORE!r}\nDS_ARGV = {DS_ARGV!r}\n"
            f"DP_ARGV = {DP_ARGV!r}\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", head + REF_SCRIPT, str(d / "ref.npz"),
         str(d / "inputs.npz"), str(d / "restore")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        subprocess.Popen(
        [sys.executable, "-c", head + LAUNCH_REF, str(d / "launch.npz"),
         str(d / "launch")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    yield procs, d
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _finish(proc, tag):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and tag in out, err[-4000:]


@pytest.fixture(scope="module")
def ref(ref_run, port):
    (proc, _), d = ref_run
    _finish(proc, "REF-OK")
    return (dict(np.load(d / "ref.npz")),
            json.loads((d / "ref.npz.json").read_text()))


@pytest.fixture(scope="module")
def launch_ref(ref_run, port):
    (_, proc), d = ref_run
    _finish(proc, "LAUNCH-OK")
    return dict(np.load(d / "launch.npz")), d


# ---------------------------------------------------------------------------
# the rank bodies
# ---------------------------------------------------------------------------

def rank_body(tasks, patch_smoke=False):
    """One rank: each (key, name, args) of `tasks` through
    `_task_<name>`, in order; their results by key.  `patch_smoke`
    makes the launcher's deepseek smoke config `_fsdp_cfg`'s, as the
    reference's launcher subprocess patches its own."""
    if patch_smoke:
        import repro_torch.configs as C
        real = C.smoke_config
        C.smoke_config = lambda arch, **kw: (
            _fsdp_cfg(arch) if arch == DEEP else real(arch, **kw))
    return {key: globals()[f"_task_{name}"](*args)
            for key, name, args in tasks}


def _rt():
    from repro_torch.core import spmd
    return spmd.current()


def _task_grads(arch, params, batch):
    """The loss, the synced gradients and one default-sync step on this
    rank's fsdp shards."""
    from repro_torch.parallel.comm import AxisSpec, Comm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as tstep
    cfg = _fsdp_cfg(arch)
    mesh = _rt().mesh
    local = {k: torch.as_tensor(v).long()
             for k, v in build.local_batch(cfg, batch, mesh).items()}
    comm = Comm(AxisSpec())
    loss, grads = tstep.loss_and_grads(comm, cfg, params, local)
    loss = comm.allreduce(loss, "data") / comm.axis_size("data")
    grads = tstep.fused_grad_sync(comm, grads,
                                  sharding.needs_data_sync(cfg, grads))
    ocfg = opt.AdamWConfig(moment_dtype=cfg.moment_dtype,
                           **({"eps": STEP_EPS} if arch == DEEP else {}))
    step, _, _ = build.make_train_step(cfg, mesh, adamw=ocfg)
    l, new, _ = step(params, opt.init_state(params, ocfg,
                                            cfg.local_global_period), batch)
    return {"loss": float(loss), "grads": grads, "step": (float(l), new)}


def _task_dp_step(params, batch):
    """One dp_only step from replicated parameters."""
    from repro_torch.train import optimizer as opt
    cfg = dataclasses.replace(smoke_config(QWEN, dtype=torch.float32),
                              shard_strategy="dp_only")
    step, _, ocfg = build.make_train_step(cfg, _rt().mesh)
    loss, new, _ = step(params, opt.init_state(params, ocfg), batch)
    return float(loss), new


def _task_gather_grad(x, w):
    """d/dx of sum(w * allgather(x)) over `data`: the sum over the data
    PEs of w's block that this PE owns."""
    from repro_torch.parallel.comm import AxisSpec, Comm
    x = x.clone().requires_grad_()
    y = Comm(AxisSpec()).allgather(x, "data", concat_axis=0)
    (w * y).sum().backward()
    return x.grad


def _task_restore(d):
    """restore(shardings=) and recover(shardings=) in this rank."""
    from repro_torch.core import elastic, sim_ctx
    tmpl = {k: torch.zeros(t) for k, (_, t, _) in RESTORE.items()}
    specs = {k: s for k, (_, _, s) in RESTORE.items()}
    step, got = ckpt.restore(d, tmpl, shardings=specs)
    rstep, rgot, dm = elastic.recover(sim_ctx(4, device="cpu"), [1], d,
                                      tmpl, shardings=specs)
    return {"step": (step, rstep), "restore": got, "recover": rgot,
            "fingerprint": dm.fingerprint}


def _task_launch_ds(init, d):
    """The launcher on deepseek: one step from `init` (the GLOBAL tree)
    with a checkpoint, then a resume of it to step 2."""
    import shutil

    from repro_torch.launch import train as train_mod
    argv = DS_ARGV + ["--device", "cpu"]
    l1 = train_mod.train_loop(train_mod.parse_args(
        argv + ["--steps", "1", "--ckpt-dir", d + "/ds"]), init).losses
    rt = _rt()
    rt.barrier()                  # rank 0's checkpoint has landed
    if rt.rank == 0:
        shutil.copytree(d + "/ds", d + "/ds-resume")
    rt.barrier()
    l2 = train_mod.train_loop(train_mod.parse_args(
        argv + ["--steps", "2", "--ckpt-dir", d + "/ds-resume",
                "--resume", "auto"])).losses
    return l1, l2


def _task_launch_dp(init):
    from repro_torch.launch import train as train_mod
    return train_mod.train_loop(train_mod.parse_args(
        DP_ARGV + ["--device", "cpu"]), init).losses


def _task_kill_resume(d):
    """FAULT_RESUME_SCRIPT on 1x2 ranks: killed at step 4's batch fetch
    after the async save at step 2 landed; resumed, and an uninterrupted
    run resumed from the same checkpoint."""
    import shutil
    import time

    from repro_torch.data import pipeline as data_mod
    from repro_torch.launch import train as train_mod
    argv = KILL_ARGV + ["--device", "cpu"]
    real = data_mod.SyntheticLM.batch

    def dying_batch(self, step):
        if step == 4:
            raise RuntimeError("injected PE failure: node lost")
        return real(self, step)

    data_mod.SyntheticLM.batch = dying_batch
    killed = ""
    try:
        train_mod.train_loop(train_mod.parse_args(
            argv + ["--ckpt-dir", d, "--steps", "6", "--ckpt-every", "2"]))
    except RuntimeError as e:
        killed = str(e)
    finally:
        data_mod.SyntheticLM.batch = real
    rt = _rt()
    if rt.rank == 0:
        for _ in range(100):      # the async save thread may be renaming
            if ckpt.latest_step(d) == 2:
                break
            time.sleep(0.1)
        shutil.copytree(d, d + "-resume")
        shutil.copytree(d, d + "-ref")
    rt.barrier()
    runs = [train_mod.train_loop(train_mod.parse_args(
        argv + ["--ckpt-dir", d + tag, "--steps", "6", "--resume", "auto",
                "--ckpt-every", "100"])).losses
        for tag in ("-resume", "-ref")]
    return {"killed": killed, "latest": ckpt.latest_step(d),
            "resumed": runs[0], "ref": runs[1]}


def _task_drain(prompts):
    """The engine on (1, 2): a PE failure at the second step's decode on
    every rank, the drain, the re-run; then an undisturbed engine on the
    same weights."""
    from repro_torch.core.fault import PEFailure
    from repro_torch.serve.engine import ServeEngine
    cfg = smoke_config(QWEN, dtype=torch.float32)
    mesh = _rt().mesh
    eng = ServeEngine(cfg, mesh, **ENGINE_KW)
    rids = [eng.submit(p, 5) for p in prompts]
    eng.step()                            # admit three, 1 token in
    active0 = sorted(eng.scheduler.active_slots())
    real, calls = transformer.decode_step_paged, {"n": 0}

    def dying_decode(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise PEFailure("PE 1 dropped off the NoC", pe=1, step=1)
        return real(*a, **k)

    with mock.patch.object(transformer, "decode_step_paged", dying_decode):
        res = eng.step()
        after = {"queue": [r.rid for r in eng.scheduler.queue],
                 "active": eng.scheduler.active_slots(),
                 "live": eng.kv.pool.live_pages(),
                 "traces": len(eng.logits_trace)}
        eng.run()
    clean = ServeEngine(cfg, mesh, params=eng.params, **ENGINE_KW)
    for p in prompts:
        clean.submit(p, 5)
    clean.run()
    return {"rids": rids, "active0": active0, "res": res, "after": after,
            "results": eng.results, "clean": clean.results}


@pytest.fixture(scope="module")
def port(inputs, ref_run, tmp_path_factory):
    """Every rank's results: one spawn of 4 ranks (2x2) for the
    shard_map cases and the checkpoint restores, one of 2 (1x2) for the
    kill-and-resume and the engine drain."""
    _, ref_dir = ref_run
    scratch = tmp_path_factory.mktemp("fsdp_port")
    # x's two row blocks, then each data PE's weight over the gathered x
    xw = np.random.default_rng(3).standard_normal((3, 8, 5)).astype(
        np.float32)
    args = []
    for r in range(4):
        mesh = RankMesh(("data", "model"), (2, 2), r)
        d = mesh.coords["data"]
        tasks = [(arch, "grads", (arch, convert.local_shards(
            inputs[arch][0], _fsdp_cfg(arch), mesh), inputs[arch][1]))
            for arch in GRAD_ARCHS]
        tasks += [("dp", "dp_step", inputs["dp"]),
                  ("gather", "gather_grad", (torch.from_numpy(
                      xw[0][4 * d:4 * d + 4]), torch.from_numpy(
                      xw[1 + d]))),
                  ("restore", "restore", (str(ref_dir / "restore"),))]
        args.append((tasks,))
    out = {"4": build.shard_mapped(rank_body, (2, 2), args, device="cpu",
                                   slot_bytes=SLOT), "xw": xw}
    tasks = [("kill", "kill_resume", (str(scratch / "kill"),)),
             ("drain", "drain", (inputs["prompts"],))]
    out["2"] = build.shard_mapped(rank_body, (1, 2), [(tasks,)] * 2,
                                  device="cpu", slot_bytes=SLOT)
    return out


@pytest.fixture(scope="module")
def port_launch(launch_ref):
    """The port's launcher runs on 2x2 ranks from the reference
    launcher's seed-0 trees."""
    got, d = launch_ref
    ds = convert.params_from_jax(_unflat(got, "ds/init"), _fsdp_cfg(DEEP))
    dp = convert.params_from_jax(_unflat(got, "dp/init"), smoke_config(QWEN))
    port_dir = pathlib.Path(d) / "port"
    tasks = [("ds", "launch_ds", (ds, str(port_dir))),
             ("dp", "launch_dp", (dp,))]
    res = build.shard_mapped(rank_body, (2, 2), [(tasks, True)] * 4,
                             device="cpu", slot_bytes=SLOT)
    return res, port_dir


# ---------------------------------------------------------------------------
# (a) specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", SPEC_MESHES, ids=["2x2", "4x1"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_fsdp_specs_shapes_and_sync_mask_equal_the_reference(ref, arch,
                                                             dims):
    """Every leaf's spec, its fsdp-localized shape and its sync flag, as
    the reference's (a per-layer leaf's spec names no `data`: the
    reference's fsdp test counts its stacked dim)."""
    want = ref[1][f"{arch}/{dims[0]}x{dims[1]}"]
    cfg = dataclasses.replace(smoke_config(arch), fsdp=True)
    mesh = build.mesh_of(*dims)
    if want == "refused":
        with pytest.raises(ValueError, match="does not split"):
            build.abstract_params(cfg, mesh)
        return
    shapes, specs = build.abstract_params(cfg, mesh)
    sync = sharding.needs_data_sync(cfg, shapes)
    got = {}

    def walk(t, s, y, path=()):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], y[k], path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, s[i], y[i], path + (str(i),))
        else:
            name, stacked = _ref_path(path, cfg)
            ent = [list(e) if isinstance(e, tuple) else e for e in s]
            got.setdefault(name, set()).add(json.dumps(
                [list(t.shape), ent, bool(y)]))
            ws, wspec, wy = want[name]
            if stacked:
                ws, wspec = ws[1:], wspec[1:]
            assert [list(t.shape), ent, bool(y)] == [ws, wspec, wy], name

    walk(shapes, specs, sync)
    assert sorted(got) == sorted(want)


# ---------------------------------------------------------------------------
# (b), (c) gradients and steps under shard_map
# ---------------------------------------------------------------------------

def _per_rank(ref, key, n=4):
    tree = _unflat(ref, key)
    flat = _flat(tree, "", {})
    return [{k: v[r] for k, v in flat.items()} for r in range(n)]


def _port_flat(tree, cfg):
    return _flat(convert.params_to_jax(tree, cfg), "", {})


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(ref, port, arch):
    """Each rank's loss and gradient leaves against its device's: the
    fsdp leaves are the gather's backward, summed over `data`."""
    arrs = ref[0]
    want = _per_rank(arrs, f"{arch}/grads/tree")
    cfg = _fsdp_cfg(arch)
    for r, res in enumerate(port["4"]):
        got = res[arch]
        np.testing.assert_allclose(got["loss"], arrs[f"{arch}/grads/loss"][r],
                                   err_msg=f"rank {r}", **TOL)
        flat = _port_flat(got["grads"], cfg)
        assert sorted(flat) == sorted(want[r])
        for k in flat:
            np.testing.assert_allclose(flat[k], want[r][k],
                                       err_msg=f"rank {r} {k}", **TOL)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_default_sync_step_matches_reference(ref, port, arch):
    """One default-sync step (deepseek: int8 moments blocked over each
    rank's local leaves): the loss and every rank's new parameters."""
    arrs = ref[0]
    want = _per_rank(arrs, f"{arch}/step/tree")
    for r, res in enumerate(port["4"]):
        loss, new = res[arch]["step"]
        np.testing.assert_allclose(loss, arrs[f"{arch}/step/loss"][r], **TOL)
        flat = _port_flat(new, _fsdp_cfg(arch))
        for k in flat:
            np.testing.assert_allclose(flat[k], want[r][k],
                                       err_msg=f"rank {r} {k}", **TOL)


def test_fsdp_leaves_are_not_synced_and_are_split_over_data(port):
    """An fsdp leaf's rows differ between the two data PEs of one model
    shard (each owns its block), a replicated leaf's are equal."""
    ranks = [r[QWEN]["grads"] for r in port["4"]]
    wq0, wq2 = (g["layers"][0]["attn"]["wq"] for g in (ranks[0], ranks[2]))
    assert wq0.shape == wq2.shape and not torch.equal(wq0, wq2)
    assert torch.equal(ranks[0]["final_norm"], ranks[2]["final_norm"])


def test_allgather_backward_sums_over_the_pes_that_read_it(port):
    """Each data PE d' computes sum(w_d' * allgather(x)) over 2 data PEs:
    x's gradient on PE d is the sum over d' of w_d''s block d — the
    fsdp gradient, summed over `data` and not averaged."""
    xw = port["xw"]
    for r, res in enumerate(port["4"]):
        d = r // 2
        want = (xw[1] + xw[2])[4 * d:4 * d + 4]
        np.testing.assert_array_equal(res["gather"].numpy(), want)


# ---------------------------------------------------------------------------
# (d) dp_only
# ---------------------------------------------------------------------------

def test_dp_only_step_matches_reference_and_model_replicas_drift(ref, port):
    """dp_only on 2x2: the batch over data x model, gradients averaged
    over `data` alone, so the two model-axis replicas (ranks 0 and 1)
    take different steps, as the reference's devices 0 and 1 do; the
    data-axis replicas (ranks 0 and 2) stay equal bit for bit."""
    arrs = ref[0]
    want = _per_rank(arrs, "dp/step/tree")
    cfg = smoke_config(QWEN)
    flats = [_port_flat(res["dp"][1], cfg) for res in port["4"]]
    for r, res in enumerate(port["4"]):
        np.testing.assert_allclose(res["dp"][0], arrs["dp/step/loss"][r],
                                   **TOL)
        for k in flats[r]:
            np.testing.assert_allclose(flats[r][k], want[r][k],
                                       err_msg=f"rank {r} {k}", **TOL)
    wq = "/layers/attn/wq"
    assert not np.array_equal(flats[0][wq], flats[1][wq])
    assert not np.array_equal(want[0][wq], want[1][wq])
    for k in flats[0]:
        np.testing.assert_array_equal(flats[0][k], flats[2][k], err_msg=k)


def test_dp_only_launcher_matches_reference_launcher(launch_ref,
                                                     port_launch):
    """--shard-strategy dp_only --data 2 --model 2 through both
    launchers from the reference's seed-0 tree, loss for loss (bf16
    compute: 2e-3)."""
    got = port_launch[0][0]["dp"]
    want = launch_ref[0]["dp/losses"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=2e-3)


# ---------------------------------------------------------------------------
# (c) the launcher's checkpoint on deepseek
# ---------------------------------------------------------------------------

def _load_ckpt(d):
    step = sorted(pathlib.Path(d).glob("step-*"))[-1]
    out = {}
    for rec in json.loads((step / "manifest.json").read_text())["leaves"]:
        a = np.load(step / rec["file"])
        out[rec["name"]] = a
    return out


LR = 3e-4                          # the launchers' default AdamW lr


def _close_up_to_rounding(got, want, name):
    """Parameters after one int8-moment AdamW step: within TOL but where
    a moment's 128-element block quantises one element to the
    neighbouring int8 level (its f32 gradient noise crosses a half
    step), which moves that element's update by a fraction of lr: at
    most 0.1% of a leaf's elements, each within 2 x lr."""
    bad = ~np.isclose(got, want, **TOL)
    assert bad.mean() <= 1e-3, (name, int(bad.sum()))
    np.testing.assert_allclose(got[bad], want[bad], rtol=0, atol=2 * LR,
                               err_msg=name)


def test_launcher_checkpoint_holds_what_the_reference_saves(launch_ref,
                                                            port_launch):
    """The deepseek launcher's checkpoint after one step, leaf for leaf
    against the reference launcher's: the parameters (through the
    reference's layout) with their shapes, a per-layer fsdp leaf holding
    data rank 0's rows; every int8 moment (q and scale, rank 0's blocks,
    moment group i against the reference's i-th leaf) and the step."""
    arrs = launch_ref[0]
    (res, d) = port_launch
    np.testing.assert_allclose(res[0]["ds"][0], arrs["ds/losses"], **TOL)
    want = {k[len("ds/ckpt/"):]: v for k, v in arrs.items()
            if k.startswith("ds/ckpt/")}
    got = _load_ckpt(d / "ds")
    cfg = _fsdp_cfg(DEEP)
    gp = {}
    for name, a in got.items():
        if name.startswith("params/"):
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

    flat = _flat(convert.params_to_jax(lists(gp), cfg), "params", {})
    wparams = {k: v for k, v in want.items() if k.startswith("params/")}
    assert sorted(flat) == sorted(wparams)
    for k in flat:
        assert flat[k].shape == wparams[k].shape, k
        _close_up_to_rounding(flat[k], wparams[k], k)
    # a per-layer fsdp leaf holds half its rows: data rank 0's
    assert want["params/layers/attn/wq_a"].shape[1] * 2 == cfg.d_model
    names = list(_flat(_unflat(wparams, "params"), "", {}))
    n_mv = len([k for k in got if k.startswith("opt/mv/")])
    assert n_mv == 4 * len(names)
    for i, name in enumerate(names):
        for mom in ("m", "v"):
            q, s = (got[f"opt/mv/{i}/{mom}/{x}"] for x in ("q", "scale"))
            wq, ws = (want[f"opt/mv{name}/{mom}/{x}"] for x in ("q", "scale"))
            assert q.shape == wq.shape and s.shape == ws.shape, name
            np.testing.assert_allclose(s, ws, err_msg=name, **TOL)
            # a block's q may round the other way where the gradient's
            # f32 noise crosses a half step: one quantum
            assert np.abs(q.astype(int) - wq.astype(int)).max() <= 1, name
    np.testing.assert_array_equal(got["opt/step"], want["opt/step"])


def test_launcher_resume_matches_the_reference_resume(launch_ref,
                                                      port_launch):
    """The checkpoint resumed to step 2 by both launchers: every data
    rank resumes with data rank 0's rows of the per-layer fsdp leaves
    and rank 0's int8 moments, as the reference's devices do."""
    got = port_launch[0][0]["ds"][1]
    want = launch_ref[0]["ds/resumed"]
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# (e) kill-and-resume, (f) restore, (g) the engine drain
# ---------------------------------------------------------------------------

def test_spmd_tp2_kill_and_resume(port):
    """A tp = 2 launcher run killed at step 4 resumes from the step-2
    checkpoint and reproduces an uninterrupted run resumed from the same
    step (the reference test's allclose)."""
    for res in port["2"]:
        got = res["kill"]
        assert "node lost" in got["killed"] and got["latest"] == 2
        assert len(got["resumed"]) == 4          # steps 2..5 replayed
        assert np.isfinite(got["resumed"]).all()
        np.testing.assert_allclose(got["resumed"], got["ref"], rtol=1e-5,
                                   atol=1e-6)


def test_restore_and_recover_with_shardings_give_each_rank_its_block(
        ref, port):
    arrs, doc = ref
    for r, res in enumerate(port["4"]):
        got = res["restore"]
        assert got["step"] == tuple(arrs["restore/step"]) == (5, 5)
        assert got["fingerprint"] == doc["recover_fingerprint"]
        for tag in ("restore", "recover"):
            for k in RESTORE:
                np.testing.assert_array_equal(
                    got[tag][k].numpy(), arrs[f"{tag}/{k}/{r}"],
                    err_msg=f"{tag} {k} rank {r}")


def test_restore_with_shardings_needs_a_rank_mesh(tmp_path):
    ckpt.save(tmp_path, 1, {"w": torch.ones(4, 2)})
    with pytest.raises(RuntimeError, match="rank process"):
        ckpt.restore(tmp_path, {"w": torch.zeros(4, 2)},
                     shardings={"w": ("data", None)})


def test_engine_drain_on_a_rank_mesh_requeues_and_regenerates_bitwise(port):
    results = [res["drain"] for res in port["2"]]
    first = results[0]
    rids = first["rids"]
    assert first["active0"] == [0, 1, 2]
    res = first["res"]
    assert res["faulted"] and res["pe"] == 1 and res["decoded"] == 0
    assert res["requeued"] == rids[:3]
    # FIFO preserved: the queue head is back in slot (admission) order
    assert first["after"] == {"queue": rids, "active": [], "live": 0,
                              "traces": 0}
    assert sorted(first["results"]) == sorted(rids)
    for r in rids:
        np.testing.assert_array_equal(first["results"][r],
                                      first["clean"][r])
    for other in results[1:]:     # every rank drained alike
        assert other["res"] == res and other["after"] == first["after"]
        for r in rids:
            np.testing.assert_array_equal(other["results"][r],
                                          first["results"][r])
