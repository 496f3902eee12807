"""Sequence sharding on the rank mesh against the reference's shard_map,
on the CPU.  The port runs in one spawn of 4 rank processes of
`core.spmd` (gloo for barriers, a shared-memory heap of small slots, so
payloads cross in chunks); a task over 2 data PEs runs on a (rep 2,
data 2, model 1) mesh, two replicas side by side.  The reference runs in
a subprocess with 4 host devices, started first, and hands its numbers
over as .npz.  Every comparison with the reference is in f32 compute,
from the same global parameters (the port's 1x1 init fitted to the mesh,
its vectors moved off their init):

  * the ring layer (`layers.attention` with attention="ring", x sharded
    over `data` by sequence, global positions) on 2 and 4 data PEs
    against the reference's ring layer under shard_map
    (`tests/test_fused.py`'s RING_SPMD) at its 2e-5, and its gradients
    (x and every weight, summed over the data PEs) against the
    reference's `jax.grad` at rtol 1e-4 / atol 1e-5;
  * the sequence-sharded decode (`build_decode_step(seq_shards)`, the
    setup of `tests/test_seq_shard_decode.py`: B 1, 10 teacher-forced
    steps against 16 slots) for gemma2 smoke (local/global, its local
    window cut to 6), danube smoke (window 6), zamba2 smoke (hybrid) at
    2 and 4 shards and qwen2 smoke at tp 2 over 2 shards: every step's
    logits and every leaf of the final cache against that device's in
    the reference's sharded step at rtol 1e-4 / atol 1e-5, and against
    the port's unsharded step at that test's TOL, in f32 and in bf16;
    the positions stay below ds x window, the reference's coverage of a
    windowed cache; the step's profiler records the combine's
    allreduces over `shards` PEs;
  * `build.make_serve_steps` at `long_500k` on 4 x 1 for zamba2-1.2b,
    mamba2-2.7b and h2o-danube-3-4b: seq_shards, the cache's local
    shapes and specs equal to the reference's; and its decode step on a
    tiny long-context cell (1 sequence of 16 slots, patched into both
    SHAPES) for zamba2 smoke, logits against the reference's.
"""
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
TOL = dict(rtol=1e-4, atol=1e-5)
# the unsharded-vs-sharded bound of tests/test_seq_shard_decode.py
SHARD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
SLOT = 1 << 16                    # heap slot bytes: payloads cross in chunks
SHARDS = (2, 4)
RING = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=128, attention="ring")
RING_B, RING_L = 2, 32
RING_WEIGHTS = ("wq", "wk", "wv", "wo")
# (tag, arch, config overrides, tp) of each sequence-sharded decode
DECODE = [("gemma2", "gemma2-9b", {"local_window": 6}, 1),
          ("danube", "h2o-danube-3-4b", {"window": 6}, 1),
          ("zamba2", "zamba2-1.2b", {}, 1),
          ("qwen2-tp2", "qwen2-0.5b", {}, 2)]
DEC_B, DEC_T, DEC_S = 1, 10, 16   # batch, steps, cache slots (global)
LONG = ["zamba2-1.2b", "mamba2-2.7b", "h2o-danube-3-4b"]
CELL = "long_tiny"                # the serve-steps cell patched into SHAPES
CELL_SPEC = dict(seq_len=16, global_batch=1, kind="decode")
CELL_STEPS = 4


def _shards_of(tp):
    return SHARDS if tp == 1 else (2,)


def _cfg(arch, dtype=torch.float32, **ov):
    return smoke_config(arch, dtype=dtype, **ov)


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


def _global_params(cfg, tp, seed):
    """Global parameters in the port's layout: its 1x1 init fitted to
    `tp`, every vector moved by 0.1 x N(0, 1)."""
    gp = convert.fit_global(transformer.init_params(cfg, seed=seed,
                                                    device="cpu"),
                            cfg, tp=tp)
    gen = torch.Generator().manual_seed(seed)
    return transformer.map_params(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=gen)
        if t.dim() == 1 else t, gp)


def _ref_cache_key(cfg, group, i):
    """The reference's stacked (group, index) of the port's cache layer
    `i` of `group`: gemma2's layers alternate pairs_local, pairs_global."""
    if cfg.local_global_period and group == "layers":
        return ("pairs_local" if i % 2 == 0 else "pairs_global"), i // 2
    return group, i


REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config, smoke_config
    from repro.core import Profiler
    from repro.launch import build
    from repro.launch.mesh import make_mesh
    from repro.models import config as mconfig
    from repro.models import layers as L
    from repro.models import transformer
    from repro.models.config import ModelConfig
    from repro.parallel import sharding
    from repro.parallel.comm import AxisSpec, Comm
    from repro.serve import step as sstep

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
                node[parts[-1]] = jnp.asarray(v)
        return tree

    def put(mesh, tree, specs):
        return jax.tree.map(lambda a, s: jax.device_put(
            jnp.asarray(a), NamedSharding(mesh, s)), tree, specs)

    # the ring layer, output and gradients
    cfg = ModelConfig(dtype=jnp.float32, **RING)
    params = unflat("ring/params")
    x, w = jnp.asarray(inputs["ring/x"]), jnp.asarray(inputs["ring/w"])
    B, Lg = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(Lg, dtype=jnp.int32), (B, Lg))
    for n in SHARDS:
        mesh = make_mesh(n, 1)
        with jax.set_mesh(mesh):
            f = build.shard_mapped(
                lambda p, x, pos: L.attention(Comm(AxisSpec(), "shmem"),
                                              cfg, p, x, pos),
                mesh, (P(), P(None, "data"), P(None, "data")),
                P(None, "data"))
            out[f"ring/{n}/out"] = np.asarray(jax.jit(f)(params, x, pos))
            gp, gx = jax.jit(jax.grad(
                lambda p, x: jnp.sum(w * f(p, x, pos)),
                argnums=(0, 1)))(params, x)
        flat(gp, f"ring/{n}/gp")
        out[f"ring/{n}/gx"] = np.asarray(gx)

    # the sequence-sharded decode steps
    B, T, S = DEC
    for tag, arch, ov, tp in DECODE:
        cfg = smoke_config(arch, dtype=jnp.float32, **ov)
        toks = inputs[f"dec/{tag}/tokens"]
        for shards in ((2, 4) if tp == 1 else (2,)):
            mesh = make_mesh(shards, tp)
            with jax.set_mesh(mesh):
                _, specs = build.abstract_params(cfg, mesh)
                params = put(mesh, unflat(f"dec/{tag}/params"), specs)
                cshapes = jax.eval_shape(lambda: transformer.init_cache(
                    cfg, tp, B, S, shards))
                cspecs = sharding.cache_specs(cfg, cshapes,
                                              build.mesh_axes(mesh), shards)
                cache = jax.jit(build.shard_mapped(
                    lambda: transformer.init_cache(cfg, tp, B, S, shards),
                    mesh, (), cspecs))()
                prof = Profiler(level=2)
                decode = sstep.build_decode_step(
                    cfg, build.axis_spec(mesh), "shmem", shards,
                    profile=prof)
                bspec = {"tokens": P(), "positions": P()}
                lspec = P(None, None, "model") if tp > 1 else P()
                djit = jax.jit(build.shard_mapped(
                    decode, mesh, (specs, cspecs, bspec), (lspec, cspecs)))
                lgs = []
                for t in range(T):
                    lg, cache = djit(params, cache, {
                        "tokens": jnp.asarray(toks[:, t:t + 1]),
                        "positions": jnp.full((B,), t, jnp.int32)})
                    lgs.append(np.asarray(lg))
            key = f"dec/{tag}/{shards}"
            out[key + "/logits"] = np.stack(lgs)
            flat(cache, key + "/cache")
            sels = [s for s in prof.samples if s.collective == "allreduce"]
            out[key + "/allreduce_pes"] = np.asarray(
                [s.n_pes for s in sels], np.int64)

    # make_serve_steps at long_500k, and its decode on a tiny cell
    def specs_of(tree, prefix):
        for k, spec in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P)):
            path = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                            for q in k)
            out[prefix + path] = np.asarray(repr(tuple(spec)))

    def shapes_of(tree, prefix):
        for k, leaf in jax.tree_util.tree_leaves_with_path(tree):
            path = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                            for q in k)
            out[prefix + path] = np.asarray(leaf.shape)

    mesh = make_mesh(4, 1)
    for arch in LONG:
        with jax.set_mesh(mesh):
            _, _, (cshapes, cspecs), _, ss = build.make_serve_steps(
                get_config(arch), mesh, "long_500k")
        out[f"long/{arch}/seq_shards"] = np.asarray(ss)
        shapes_of(cshapes, f"long/{arch}/shape/")
        specs_of(cspecs, f"long/{arch}/spec/")
    mconfig.SHAPES[CELL] = CELL_SPEC
    cfg = smoke_config("zamba2-1.2b", dtype=jnp.float32)
    with jax.set_mesh(mesh):
        _, dec, (cshapes, cspecs), (_, pspecs), ss = \\
            build.make_serve_steps(cfg, mesh, CELL)
        params = put(mesh, unflat("steps/params"), pspecs)
        toks = inputs["steps/tokens"]
        cache = jax.jit(build.shard_mapped(
            lambda: transformer.init_cache(cfg, 1, CELL_SPEC["global_batch"],
                                           CELL_SPEC["seq_len"], ss),
            mesh, (), cspecs))()
        bt = {"tokens": jnp.asarray(toks[:, :1]),
              "positions": jnp.zeros((toks.shape[0],), jnp.int32)}
        dstep = jax.jit(dec(bt))
        lgs = []
        for t in range(toks.shape[1]):
            lg, cache = dstep(params, cache, {
                "tokens": jnp.asarray(toks[:, t:t + 1]),
                "positions": jnp.full((toks.shape[0],), t, jnp.int32)})
            lgs.append(np.asarray(lg))
        out["steps/logits"] = np.stack(lgs)
        out["steps/seq_shards"] = np.asarray(ss)
    np.savez(sys.argv[1], **out)
    print("REF-OK")
""")


@pytest.fixture(scope="module")
def inputs():
    """The ring layer's weights, input and cotangent weights; per decode
    case its global parameters (port layout) and tokens; the tiny cell's
    parameters and tokens."""
    rng = np.random.default_rng(27)
    cfg = _ring_cfg()
    d, hd = cfg.d_model, cfg.hd
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(cfg.n_heads * hd)
    out = {"ring": dict(
        params={"wq": rng.normal(size=(d, cfg.n_heads * hd)) * s_in,
                "wk": rng.normal(size=(d, cfg.n_kv_heads * hd)) * s_in,
                "wv": rng.normal(size=(d, cfg.n_kv_heads * hd)) * s_in,
                "wo": rng.normal(size=(cfg.n_heads * hd, d)) * s_out},
        x=rng.normal(size=(RING_B, RING_L, d)),
        w=rng.normal(size=(RING_B, RING_L, d)))}
    out["ring"] = {k: ({n: a.astype(np.float32) for n, a in v.items()}
                       if isinstance(v, dict) else v.astype(np.float32))
                   for k, v in out["ring"].items()}
    for i, (tag, arch, ov, tp) in enumerate(DECODE):
        cfg = _cfg(arch, **ov)
        out[f"dec/{tag}"] = (_global_params(cfg, tp, 70 + i), rng.integers(
            1, cfg.vocab, size=(DEC_B, DEC_T)).astype(np.int32))
    cfg = _cfg("zamba2-1.2b")
    out["steps"] = (_global_params(cfg, 1, 80), rng.integers(
        1, cfg.vocab, size=(CELL_SPEC["global_batch"], CELL_STEPS)
    ).astype(np.int32))
    return out


def _ring_cfg(dtype=torch.float32):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(dtype=dtype, **RING)


@pytest.fixture(scope="module")
def ref_run(inputs, tmp_path_factory):
    """The reference's subprocess, started on the same inputs and left to
    run while the port's ranks run."""
    d = tmp_path_factory.mktemp("seq_shard")
    arrs = {"ring/x": inputs["ring"]["x"], "ring/w": inputs["ring"]["w"]}
    arrs.update({f"ring/params/{k}": v
                 for k, v in inputs["ring"]["params"].items()})
    for tag, arch, ov, _ in DECODE:
        gp, toks = inputs[f"dec/{tag}"]
        _flat(convert.params_to_jax(gp, _cfg(arch, **ov)),
              f"dec/{tag}/params", arrs)
        arrs[f"dec/{tag}/tokens"] = toks
    gp, toks = inputs["steps"]
    _flat(convert.params_to_jax(gp, _cfg("zamba2-1.2b")), "steps/params",
          arrs)
    arrs["steps/tokens"] = toks
    np.savez(d / "inputs.npz", **arrs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    script = (f"RING = {RING!r}\nSHARDS = {SHARDS!r}\n"
              f"DECODE = {DECODE!r}\nDEC = {(DEC_B, DEC_T, DEC_S)!r}\n"
              f"LONG = {LONG!r}\nCELL = {CELL!r}\n"
              f"CELL_SPEC = {CELL_SPEC!r}\n" + REF_SCRIPT)
    proc = subprocess.Popen(
        [sys.executable, "-c", script, str(d / "ref.npz"),
         str(d / "inputs.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_run, port):
    proc, d = ref_run
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0 and "REF-OK" in out, err[-4000:]
    return dict(np.load(d / "ref.npz"))


# ---------------------------------------------------------------------------
# the port's rank processes
# ---------------------------------------------------------------------------

def rank_body(tasks):
    """One rank: each (key, name, mesh, args) of `tasks` through
    `_task_<name>` on that mesh, in order; their results by key."""
    from repro_torch.launch.mesh import make_rank_mesh
    out = {}
    for key, name, (shape, axes), args in tasks:
        make_rank_mesh(shape, axes)
        out[key] = globals()[f"_task_{name}"](*args)
    return out


def _mesh_of(shards, tp):
    """The rank mesh of a task over `shards` data PEs at `tp` in the
    4-rank run: replicas of it side by side on a leading "rep" axis."""
    rep = 4 // (shards * tp)
    return ((rep, shards, tp), ("rep", "data", "model"))


def _task_ring(params, x, w):
    """The ring layer on this rank's sequence shard of x: its output,
    then the gradients of sum(w * out) for its x rows and its partial of
    each weight."""
    from repro_torch.core import spmd
    from repro_torch.models import layers as L
    from repro_torch.parallel.comm import AxisSpec, Comm
    mesh = spmd.current().mesh
    n, d = mesh.axis_size("data"), mesh.axis_index("data")
    ls = x.shape[1] // n
    rows = slice(d * ls, (d + 1) * ls)
    p = {k: torch.as_tensor(v).requires_grad_() for k, v in params.items()}
    xs = torch.as_tensor(x[:, rows]).requires_grad_()
    pos = torch.arange(x.shape[1])[rows].expand(x.shape[0], ls)
    o = L.attention(Comm(AxisSpec()), _ring_cfg(), p, xs, pos)
    (torch.as_tensor(w[:, rows]) * o).sum().backward()
    return {"out": o.detach(), "gx": xs.grad,
            "gp": {k: t.grad for k, t in p.items()}}


def _task_decode(arch, ov, dtype, params, tokens, shards):
    """DEC_T teacher-forced steps of `build_decode_step(seq_shards=
    shards)` against `init_cache(seq_shards=shards)` on this rank's
    shards, with a level-2 profiler on its Comm: every step's logits,
    the final cache and the PE counts of the allreduces it recorded."""
    from repro_torch.core.profile import Profiler
    from repro_torch.core import spmd
    from repro_torch.parallel.comm import AxisSpec
    from repro_torch.serve import step as sstep
    cfg = _cfg(arch, dtype, **ov)
    tp = spmd.current().mesh.axis_size("model")
    prof = Profiler(level=2)
    decode = sstep.build_decode_step(cfg, AxisSpec(), seq_shards=shards,
                                     profile=prof)
    cache = transformer.init_cache(cfg, tp, DEC_B, DEC_S, shards,
                                   device="cpu")
    toks = torch.as_tensor(tokens).long()
    lgs = []
    for t in range(toks.shape[1]):
        lg, cache = decode(params, cache, {"tokens": toks[:, t:t + 1],
                                           "positions": torch.full(
                                               (DEC_B,), t)})
        lgs.append(lg.float())
    return {"logits": torch.stack(lgs), "cache": cache,
            "allreduce_pes": [s.n_pes for s in prof.samples
                              if s.collective == "allreduce"]}


def _task_steps(params, tokens):
    """`make_serve_steps` on CELL over this 4 x 1 mesh: the decode
    step's logits over CELL_STEPS teacher-forced steps (the global batch
    handed in, replicated to every rank), the cache's shapes, specs and
    seq_shards."""
    from repro_torch.core import spmd
    from repro_torch.models import config as mconfig
    mconfig.SHAPES[CELL] = CELL_SPEC
    cfg = _cfg("zamba2-1.2b")
    _, dec, (cshapes, cspecs), _, ss = build.make_serve_steps(
        cfg, spmd.current().mesh, CELL)
    cache = transformer.map_params(
        lambda t: torch.zeros(t.shape, dtype=t.dtype), cshapes)
    B = tokens.shape[0]
    lgs = []
    for t in range(tokens.shape[1]):
        lg, cache = dec(params, cache, {"tokens": tokens[:, t:t + 1],
                                        "positions": np.full((B,), t)})
        lgs.append(lg.clone())
    return {"logits": torch.stack(lgs), "seq_shards": ss,
            "shapes": transformer.map_params(lambda t: tuple(t.shape),
                                             cshapes)}


def _local(gp, cfg, shards, tp, rank):
    """`rank`'s shards of the global tree on its (rep, data, model)
    mesh: the data x model coordinates of its replica."""
    (rep, ds, m), _ = _mesh_of(shards, tp)
    r = rank % (ds * m)
    return convert.local_shards(gp, cfg, RankMesh(("data", "model"),
                                                  (ds, m), r))


def _decode_tasks(inputs, rank):
    tasks = []
    for tag, arch, ov, tp in DECODE:
        gp, toks = inputs[f"dec/{tag}"]
        for dt in (torch.float32, torch.bfloat16):
            for shards in (1,) + _shards_of(tp):
                mesh = _mesh_of(shards, tp)
                local = _local(gp, _cfg(arch, **ov), shards, tp, rank)
                tasks.append(((tag, str(dt)[6:], shards), "decode", mesh,
                              (arch, ov, dt, local, toks, shards)))
    return tasks


@pytest.fixture(scope="module")
def port(inputs, ref_run):
    """Every rank's results of one spawn of 4 ranks."""
    args = []
    for r in range(4):
        ring = inputs["ring"]
        tasks = [(("ring", n), "ring", _mesh_of(n, 1),
                  (ring["params"], ring["x"], ring["w"])) for n in SHARDS]
        tasks += _decode_tasks(inputs, r)
        gp, toks = inputs["steps"]
        tasks.append(("steps", "steps", ((4, 1), ("data", "model")),
                      (gp, toks)))
        args.append((tasks,))
    return build.shard_mapped(rank_body, (4, 1), args, device="cpu",
                              slot_bytes=SLOT)


def _coords(shards, tp, rank):
    """(data index, model index) of `rank` on its task's mesh."""
    (_, ds, m), _ = _mesh_of(shards, tp)
    return divmod(rank % (ds * m), m)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", SHARDS)
def test_ring_layer_matches_the_reference_ring(ref, port, shards):
    """`layers.attention(attention="ring")` over `shards` data PEs: each
    rank's output rows within RING_SPMD's 2e-5 of the reference's ring
    layer under shard_map on the same global sequence."""
    want = ref[f"ring/{shards}/out"]
    ls = RING_L // shards
    for r, got in enumerate(port):
        d, _ = _coords(shards, 1, r)
        res = got[("ring", shards)]["out"].numpy()
        err = np.abs(res - want[:, d * ls:(d + 1) * ls]).max()
        assert err < 2e-5, (shards, r, err)


@pytest.mark.parametrize("shards", SHARDS)
def test_ring_layer_gradients_match_the_reference(ref, port, shards):
    """The gradients of sum(w * out) through the ring (kernel 6's
    autograd Function, the puts' inverse deliveries): each rank's x rows
    against the reference's `jax.grad`, and each weight's partials summed
    over one replica's data PEs against its gradient, at rtol 1e-4 /
    atol 1e-5."""
    ls = RING_L // shards
    gx = ref[f"ring/{shards}/gx"]
    for r, got in enumerate(port):
        d, _ = _coords(shards, 1, r)
        np.testing.assert_allclose(got[("ring", shards)]["gx"].numpy(),
                                   gx[:, d * ls:(d + 1) * ls],
                                   err_msg=f"rank {r} x", **TOL)
    for k in RING_WEIGHTS:
        for rep in range(4 // shards):
            total = sum(port[rep * shards + d][("ring", shards)]["gp"][k]
                        for d in range(shards))
            np.testing.assert_allclose(total.numpy(),
                                       ref[f"ring/{shards}/gp/{k}"],
                                       err_msg=f"{k} replica {rep}", **TOL)


def _cases():
    return [(tag, shards) for tag, _, _, tp in DECODE
            for shards in _shards_of(tp)]


def _case(tag):
    return next(c for c in DECODE if c[0] == tag)


@pytest.mark.parametrize("tag,shards", _cases())
def test_sharded_decode_matches_the_reference_sharded_step(ref, port, tag,
                                                           shards):
    """Every step's logits (this rank's vocabulary shard at tp 2) and
    every leaf of the final cache (this rank's sequence shard and heads)
    against the reference's sequence-sharded step on the same mesh, in
    f32, at rtol 1e-4 / atol 1e-5."""
    _, arch, ov, tp = _case(tag)
    cfg = _cfg(arch, **ov)
    key = f"dec/{tag}/{shards}"
    want_lg = ref[key + "/logits"]
    want_cache = _unflat(ref, key + "/cache")
    for r, got in enumerate(port):
        d, m = _coords(shards, tp, r)
        res = got[(tag, "float32", shards)]
        lg = res["logits"].numpy()
        vl = lg.shape[-1]
        np.testing.assert_allclose(lg, want_lg[..., m * vl:(m + 1) * vl],
                                   err_msg=f"rank {r} logits", **TOL)
        n = 0
        for group, layers in res["cache"].items():
            for i, c in enumerate(layers):
                g, j = _ref_cache_key(cfg, group, i)
                for leaf, t in c.items():
                    w = want_cache[g][leaf][j]
                    if leaf in ("k", "v"):       # (B, S, H, hd)
                        s, h = t.shape[1], t.shape[2]
                        w = w[:, d * s:(d + 1) * s, m * h:(m + 1) * h]
                    np.testing.assert_allclose(
                        t.numpy(), w, err_msg=f"rank {r} {group}/{i}/{leaf}",
                        **TOL)
                    n += 1
        assert n == sum(len(c) for layers in res["cache"].values()
                        for c in layers) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tag,shards", _cases())
def test_sharded_decode_matches_the_unsharded_step(port, tag, shards,
                                                   dtype):
    """The port's sequence-sharded step against its unsharded step on
    the same parameters (test_seq_shard_decode's bound per dtype), every
    step's logits, on every rank."""
    tp = _case(tag)[3]
    for r, got in enumerate(port):
        res = got[(tag, dtype, shards)]["logits"]
        want = got[(tag, dtype, 1)]["logits"]
        assert torch.isfinite(res).all()
        err = (res - want).abs().max().item()
        assert err < SHARD_TOL[dtype], (tag, shards, dtype, r, err, tp)


@pytest.mark.parametrize("tag,shards", _cases())
def test_sharded_decode_profiles_its_combines(ref, port, tag, shards):
    """The decode step's Comm carries the profiler, as the reference's
    (whose samples, recorded as its step is traced, are allreduces over
    `shards` PEs): every allreduce sample of the port's steps is over
    `shards` PEs, at least the softmax combines' (a max and two sums an
    attention layer a step; at tp 2 the allreduces over `model`, of 2
    PEs too, come on top)."""
    _, arch, ov, tp = _case(tag)
    cfg = _cfg(arch, **ov)
    n_attn = (transformer.n_shared_blocks(cfg) if cfg.family == "hybrid"
              else cfg.n_layers)
    want = ref[f"dec/{tag}/{shards}/allreduce_pes"]
    assert len(want) and all(n == shards for n in want if n)
    for got in port:
        pes = got[(tag, "float32", shards)]["allreduce_pes"]
        assert all(n == shards for n in pes), pes
        assert len(pes) >= 3 * n_attn * DEC_T
        if tp == 1:
            assert len(pes) == 3 * n_attn * DEC_T


@pytest.mark.parametrize("arch", LONG)
def test_make_serve_steps_long_500k_equals_the_reference(ref, arch):
    """`make_serve_steps` at long_500k on a 4 x 1 mesh: seq_shards 4, the
    rank's cache leaves (B 1, 524288 / 4 slots, or a window's) and their
    specs (the sequence over `data`, the batch replicated) equal to the
    reference's, leaf by leaf."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    _, _, (cshapes, cspecs), _, ss = build.make_serve_steps(
        cfg, build.mesh_of(4, 1), "long_500k")
    assert ss == int(ref[f"long/{arch}/seq_shards"]) == 4
    n = 0
    for group, layers in cshapes.items():
        for i, c in enumerate(layers):
            g, j = _ref_cache_key(cfg, group, i)
            for leaf, t in c.items():
                want = ref[f"long/{arch}/shape/{g}/{leaf}"]
                assert tuple(t.shape) == tuple(want[1:].tolist()), \
                    (group, i, leaf)
                spec = eval(str(ref[f"long/{arch}/spec/{g}/{leaf}"]))
                assert cspecs[group][i][leaf] == tuple(spec)[1:]
                n += 1
    assert n > 0


def test_make_serve_steps_decode_on_a_long_cell_matches(ref, port):
    """`make_serve_steps`' decode on a tiny long-context cell (1 sequence
    of 16 slots, below the data size of 4) for zamba2 smoke: the global
    batch is handed to every rank whole (`local_batch` with seq_shards),
    and each rank's logits of every step equal the reference's."""
    want = ref["steps/logits"]
    for r, got in enumerate(port):
        res = got["steps"]
        assert res["seq_shards"] == int(ref["steps/seq_shards"]) == 4
        assert all(c["k"][1] == CELL_SPEC["seq_len"] // 4
                   for c in res["shapes"]["shared"])
        np.testing.assert_allclose(res["logits"].numpy(), want,
                                   err_msg=f"rank {r}", **TOL)
