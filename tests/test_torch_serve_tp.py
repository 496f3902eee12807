"""Serving at tp > 1 on the rank mesh against the reference's shard_map,
on the CPU.  The port runs in rank processes of `core.spmd` (gloo for
barriers, a shared-memory heap of small slots, so payloads cross in
chunks), one spawn of 2 ranks and one of 4 shared by the tests; the
reference runs in a subprocess with 4 host devices, started first, and
hands its numbers over as .npz.  Every comparison is in f32 compute
(smoke configs with dtype float32 on both sides), from the same global
parameters (the port's 1x1 init fitted to the mesh by
`convert.fit_global`, its vectors moved off their init so that a shard
cut or laid out wrong shows), carried to the reference by
`convert.params_to_jax` and to the ranks by `convert.shards_from_jax`:

  * `kv_cache_plan` equal to the reference's at tp 2, 4, 8 and 16 for
    the full config of every arch with attention heads; the decode
    path's index tensors and ghost mask built once a rank;
  * the paged engine on 1x2 (smoke qwen2: 3 q heads over 1 kv head, a
    ghost head on rank 1) and on 1x4 (`n_heads=6, n_kv_heads=2`: ndk 2,
    padded on ranks 0, 2 and 3, two ghost heads on rank 3): its page
    size and page count equal the reference engine's, its tokens equal,
    its captured logits (gathered over `model`) within rtol 1e-4 / atol
    1e-5, batched equal to alone bit for bit (each request alone in slot
    0, whatever its slot in the batch: fault C8's repair), every rank's
    results equal to rank 0's; a PE failure on a mesh drained alike on
    every rank;
  * the cross-shard greedy tie-break of the reference's
    `test_spmd_engine_and_tiebreak` (3, 9, 0, 12) on 1x2;
  * `decode_step` on the dense cache at tp 2 for qwen2, mamba2, zamba2,
    granite (experts over `model`) and deepseek (MLA, experts over
    `model`): 4 teacher-forced steps, every step's logits and every
    cache leaf of every rank against that device's in the reference;
  * `sharding.cache_specs` equal to the reference's rules leaf by leaf;
  * `build.make_serve_steps` on a small decode cell patched into both
    SHAPES, on 2x2: the prefill's and every decode step's logits and
    the cache's shapes and specs against the reference's; long_500k's
    batch of 1 on a data axis of 2 sharding the cache's sequence
    (seq_shards 2), its shapes and specs the reference's;
  * the serve launcher at --data 2 --model 2 (the dense-cache loop, the
    batch over `data`) token for token against the reference launcher,
    both on its seed-0 init;
  * fault C6: every option string of the reference's launchers accepted
    by the port's parser of the same name, --comm xla runs; fault C7's
    path: `attention="ring"` on a data axis of 2 PEs
    (x sharded by sequence) against the reference's ring layer on 2x1,
    and on a data axis of 1 the mono attention, bit for bit.
"""
import contextlib
import io
import os
import re
import subprocess
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.launch import build
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import convert, transformer

ROOT = os.path.join(os.path.dirname(__file__), "..")
QWEN = "qwen2-0.5b"
OVERRIDE = {"n_heads": 6, "n_kv_heads": 2}
# (tag, arch, mesh, config overrides) of each engine run
ENGINES = [("qwen2", QWEN, (1, 2), {}), ("qwen2-6-2", QWEN, (1, 4), OVERRIDE)]
ENGINE_KW = dict(max_slots=3, page_size=8, max_seq=32, prompt_bucket=16)
NEW = 5                           # new tokens a request
DECODE = ["qwen2-0.5b", "mamba2-2.7b", "zamba2-1.2b",
          "granite-moe-3b-a800m", "deepseek-v3-671b"]
DEC_B, DEC_S, DEC_STEPS = 4, 8, 4     # batch, cache slots, decode steps
CELL = "decode_tiny"              # the serve-steps cell patched into SHAPES
CELL_SPEC = dict(seq_len=8, global_batch=4, kind="decode")
STEPS_DIMS = (2, 2)
LAUNCH_ARGV = ["--arch", QWEN, "--smoke", "--data", "2", "--model", "2",
               "--batch", "4", "--prompt-len", "6", "--tokens", "4",
               "--cache-len", "16"]
TOL = dict(rtol=1e-4, atol=1e-5)
C7_SEED = 3                       # the ring layer's weights (C7's path)
SLOT = 1 << 16                    # heap slot bytes: payloads cross in chunks


def _cfg(arch, **ov):
    return smoke_config(arch, dtype=torch.float32, **ov)


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


def _global_params(cfg, dims, seed):
    """Global parameters of a `dims` mesh in the port's layout: the
    port's own 1x1 init fitted to the mesh, every vector (norms, biases,
    SSM decays and skips: zero or constant at init) moved by 0.1 x N(0,
    1)."""
    gp = convert.fit_global(transformer.init_params(cfg, seed=seed,
                                                    device="cpu"),
                            cfg, tp=dims[1], dp=dims[0])
    gen = torch.Generator().manual_seed(seed)
    return transformer.map_params(
        lambda t: t + 0.1 * torch.randn(t.shape, generator=gen)
        if t.dim() == 1 else t, gp)


def _stacked_cache(cache):
    """A port decode cache (one dict per layer) in the reference's
    stacked layout, flat: "group/leaf" -> (n, ...)."""
    return {f"{g}/{k}": torch.stack([c[k] for c in layers]).numpy()
            for g, layers in cache.items() for k in layers[0]}


REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import smoke_config
    from repro.launch import build
    from repro.launch.mesh import make_mesh
    from repro.models import config as mconfig
    from repro.models import layers as L
    from repro.models import transformer
    from repro.parallel.comm import AxisSpec, Comm
    from repro.serve.engine import ServeEngine

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

    STACK = P(("data", "model"))
    prompts = [inputs[f"prompt/{i}"] for i in range(N_PROMPTS)]
    for tag, arch, dims, ov in ENGINES:
        cfg = smoke_config(arch, dtype=jnp.float32, **ov)
        mesh = make_mesh(*dims)
        _, specs = build.abstract_params(cfg, mesh)
        params = put(mesh, unflat(f"eng/{tag}/params"), specs)
        eng = ServeEngine(cfg, mesh, params=params, capture_logits=True,
                          **ENGINE_KW)
        rids = [eng.submit(p, NEW) for p in prompts]
        eng.run()
        for i, r in enumerate(rids):
            out[f"eng/{tag}/tokens/{i}"] = eng.results[r]
            out[f"eng/{tag}/logits/{i}"] = np.stack(eng.logits_trace[r])
        out[f"eng/{tag}/page_bytes"] = np.asarray(eng.page_bytes)
        out[f"eng/{tag}/num_pages"] = np.asarray(eng.kv.pool.num_pages)

    B, S, STEPS = DEC
    for arch in DECODE:
        cfg = smoke_config(arch, dtype=jnp.float32)
        mesh = make_mesh(1, 2)
        with jax.set_mesh(mesh):
            _, specs = build.abstract_params(cfg, mesh)
            params = put(mesh, unflat(f"dec/{arch}/params"), specs)
            toks = jnp.asarray(inputs[f"dec/{arch}/tokens"])
            cshapes = jax.eval_shape(lambda: transformer.init_cache(
                cfg, 2, B, S, 1))

            def body(p, toks):
                comm = Comm(AxisSpec(), "shmem")
                cache = transformer.init_cache(cfg, 2, B, S, 1)
                lgs = []
                for t in range(STEPS):
                    lg, cache = transformer.decode_step(
                        comm, cfg, p, cache, toks[:, t:t + 1],
                        jnp.full((B,), t, jnp.int32))
                    lgs.append(lg)
                return jnp.stack(lgs)[None], jax.tree.map(
                    lambda a: a[None], cache)

            lg, cache = jax.jit(build.shard_mapped(
                body, mesh, (specs, P()),
                (STACK, jax.tree.map(lambda _: STACK, cshapes))))(
                params, toks)
        out[f"dec/{arch}/logits"] = np.asarray(lg)
        flat(cache, f"dec/{arch}/cache")

    mconfig.SHAPES[CELL] = CELL_SPEC
    cfg = smoke_config(QWEN, dtype=jnp.float32)
    mesh = make_mesh(*STEPS_DIMS)
    with jax.set_mesh(mesh):
        pre, dec, (cshapes, cspecs), (_, pspecs), ss = \\
            build.make_serve_steps(cfg, mesh, CELL)
        params = put(mesh, unflat("steps/params"), pspecs)
        toks = inputs["steps/tokens"]
        Bc = toks.shape[0]
        out["steps/prefill"] = np.asarray(jax.jit(pre(
            {"tokens": toks}))(params, {"tokens": jnp.asarray(toks)}))
        cache = jax.jit(build.shard_mapped(
            lambda: transformer.init_cache(
                cfg, STEPS_DIMS[1], Bc // STEPS_DIMS[0],
                CELL_SPEC["seq_len"], 1), mesh, (), cspecs))()
        bt = {"tokens": jnp.asarray(toks[:, :1]),
              "positions": jnp.zeros((Bc,), jnp.int32)}
        dstep = jax.jit(dec(bt))
        lgs = []
        for t in range(STEPS):
            lg, cache = dstep(params, cache, {
                "tokens": jnp.asarray(toks[:, t:t + 1]),
                "positions": jnp.full((Bc,), t, jnp.int32)})
            lgs.append(np.asarray(lg))
        out["steps/logits"] = np.stack(lgs)
        for k, leaf in jax.tree_util.tree_leaves_with_path(cshapes):
            path = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                            for q in k)
            out["steps/shape/" + path] = np.asarray(leaf.shape)
        for k, spec in jax.tree_util.tree_leaves_with_path(
                cspecs, is_leaf=lambda x: isinstance(x, P)):
            path = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                            for q in k)
            out["steps/spec/" + path] = np.asarray(repr(tuple(spec)))
        out["steps/seq_shards"] = np.asarray(ss)

    # fault C7's path: the ring layer on 2x1, x sharded by sequence
    ring = dataclasses.replace(smoke_config(QWEN, dtype=jnp.float32),
                               attention="ring")
    attn = jax.tree.map(lambda a: jnp.asarray(a)[0],
                        unflat("c7/params")["layers"]["attn"])
    x = jnp.asarray(inputs["c7/x"])
    pos = jnp.broadcast_to(jnp.arange(x.shape[1], dtype=jnp.int32),
                           x.shape[:2])
    mesh = make_mesh(2, 1)
    with jax.set_mesh(mesh):
        out["c7/ring"] = np.asarray(jax.jit(build.shard_mapped(
            lambda p, x, pos: L.attention(Comm(AxisSpec(), "shmem"), ring,
                                          p, x, pos),
            mesh, (P(), P(None, "data"), P(None, "data")),
            P(None, "data")))(attn, x, pos))
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
    from repro.launch.mesh import make_mesh
    out = {}

    def flat(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                flat(tree[k], prefix + "/" + k)
        else:
            out[prefix] = np.asarray(tree)

    orig = rconfigs.smoke_config
    rconfigs.smoke_config = lambda a, **kw: orig(a, dtype=jnp.float32, **kw)
    cfg = dataclasses.replace(rconfigs.smoke_config(ARCH), fsdp=False)
    mesh = make_mesh(2, 2)
    with jax.set_mesh(mesh):           # the launcher's own seed-0 init
        init_fn, _, _ = build.make_init_fn(cfg, mesh)
        flat(jax.jit(init_fn)(jax.random.key(0)), "params")
    out["tokens"] = np.asarray(serve_mod.main(ARGV))
    np.savez(sys.argv[1], **out)
    print("LAUNCH-OK")
""")


@pytest.fixture(scope="module")
def inputs():
    """Prompts, and per engine run, decode arch and the serve-steps cell
    its global parameters (port layout) and token ids."""
    rng = np.random.default_rng(7)
    out = {"prompts": [rng.integers(1, 128, size=n).astype(np.int32)
                       for n in (5, 9, 3)]}
    for i, (tag, arch, dims, ov) in enumerate(ENGINES):
        out[f"eng/{tag}"] = _global_params(_cfg(arch, **ov), dims, 40 + i)
    for i, arch in enumerate(DECODE):
        cfg = _cfg(arch)
        out[f"dec/{arch}"] = (
            _global_params(cfg, (1, 2), 50 + i),
            rng.integers(1, cfg.vocab, size=(DEC_B, DEC_STEPS)).astype(
                np.int32))
    cfg = _cfg(QWEN)
    out["steps"] = (_global_params(cfg, STEPS_DIMS, 60),
                    rng.integers(1, cfg.vocab, size=(
                        CELL_SPEC["global_batch"], CELL_SPEC["seq_len"])
                    ).astype(np.int32))
    out["c7/x"] = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ref_run(inputs, tmp_path_factory):
    """The reference's subprocesses (the shard_map cases, and the serve
    launcher), started on the same inputs and left to run while the
    port's ranks run."""
    d = tmp_path_factory.mktemp("serve_tp")
    arrs = {f"prompt/{i}": p for i, p in enumerate(inputs["prompts"])}
    for tag, arch, _, ov in ENGINES:
        _flat(convert.params_to_jax(inputs[f"eng/{tag}"], _cfg(arch, **ov)),
              f"eng/{tag}/params", arrs)
    for arch in DECODE:
        gp, toks = inputs[f"dec/{arch}"]
        _flat(convert.params_to_jax(gp, _cfg(arch)), f"dec/{arch}/params",
              arrs)
        arrs[f"dec/{arch}/tokens"] = toks
    gp, toks = inputs["steps"]
    _flat(convert.params_to_jax(gp, _cfg(QWEN)), "steps/params", arrs)
    arrs["steps/tokens"] = toks
    _flat(convert.params_to_jax(transformer.init_params(
        _cfg(QWEN), seed=C7_SEED, device="cpu"), _cfg(QWEN)), "c7/params",
        arrs)
    arrs["c7/x"] = inputs["c7/x"]
    np.savez(d / "inputs.npz", **arrs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    script = (f"ENGINES = {ENGINES!r}\nENGINE_KW = {ENGINE_KW!r}\n"
              f"NEW = {NEW!r}\nN_PROMPTS = {len(inputs['prompts'])}\n"
              f"DECODE = {DECODE!r}\nDEC = {(DEC_B, DEC_S, DEC_STEPS)!r}\n"
              f"CELL = {CELL!r}\nCELL_SPEC = {CELL_SPEC!r}\n"
              f"STEPS_DIMS = {STEPS_DIMS!r}\nSTEPS = {DEC_STEPS!r}\n"
              f"QWEN = {QWEN!r}\n" + REF_SCRIPT)
    launch = (f"ARCH = {QWEN!r}\nARGV = {LAUNCH_ARGV!r}\n" + LAUNCH_REF)
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
def ref(ref_run, port):
    (proc, _), d = ref_run
    return _wait(proc, d, "ref.npz", "REF-OK")


# ---------------------------------------------------------------------------
# the port's rank processes
# ---------------------------------------------------------------------------

def rank_body(tasks):
    """One rank: each (key, name, args) of `tasks` through
    `_task_<name>`, in order; their results by key."""
    return {key: globals()[f"_task_{name}"](*args)
            for key, name, args in tasks}


def _mesh():
    from repro_torch.core import spmd
    return spmd.current().mesh


def _task_tie(logits):
    """The reference's tie-break cases: this rank's vocabulary shard of
    the (4, 16) logits through `sample_greedy`."""
    from repro_torch.parallel.comm import AxisSpec, Comm
    from repro_torch.serve import step as sstep
    mesh = _mesh()
    vl = logits.shape[1] // mesh.sizes["model"]
    r = mesh.axis_index("model")
    return sstep.sample_greedy(Comm(AxisSpec()),
                               torch.as_tensor(logits[:, r * vl:(r + 1) * vl]))


def _task_engine(cfg, params, prompts):
    """The engine on this rank's shards: every prompt batched (request i
    in slot i: free slots fill in slot order), then each alone on a
    second engine, drained between requests, so that each runs in slot 0
    with every other row inactive.  (Fault C8: on the CPU PyTorch's
    vectorized `F.silu` rounded the tail of a tensor whose size is not a
    multiple of its unrolled vector width in a path of its own, so at tp
    2 the MLP's 48 columns over 3 rows made row 2's last bits depend on
    its slot; the MLP's silu on the CPU is now elementwise alike.)"""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, _mesh(), params=params, capture_logits=True,
                      **ENGINE_KW)
    rids = [eng.submit(p, NEW) for p in prompts]
    eng.run()
    solo = ServeEngine(cfg, _mesh(), params=params, capture_logits=True,
                       **ENGINE_KW)
    alone = []
    for p in prompts:
        s = solo.submit(p, NEW)
        solo.run()
        assert solo.results[s].size == NEW
        alone.append((solo.results[s], np.stack(solo.logits_trace[s])))
    return dict(tokens=[eng.results[r] for r in rids],
                logits=[np.stack(eng.logits_trace[r]) for r in rids],
                alone=alone, results=eng.results, page_bytes=eng.page_bytes,
                num_pages=eng.kv.pool.num_pages)


def _task_fault(cfg, params, prompt):
    """A PE failure in the decode step on a mesh, raised on every rank:
    each rank drains its scheduler replica (tests/test_torch_fsdp.py
    holds the drain and its re-run to the reference's test)."""
    from repro_torch.core.fault import PEFailure
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, _mesh(), params=params, **ENGINE_KW)
    eng.submit(prompt, 3)
    with mock.patch.object(transformer, "decode_step_paged",
                           side_effect=PEFailure("PE 1 lost", pe=1)):
        res = eng.step()
    return dict(res, live=eng.kv.pool.live_pages())


def _task_decode(arch, params, tokens):
    """DEC_STEPS teacher-forced dense-cache decode steps on this rank's
    shards: every step's logits and the final cache."""
    from repro_torch.parallel.comm import AxisSpec, Comm
    cfg = _cfg(arch)
    comm = Comm(AxisSpec())
    cache = transformer.init_cache(cfg, _mesh().sizes["model"], DEC_B,
                                   DEC_S, device="cpu")
    toks = torch.as_tensor(tokens).long()
    lgs = []
    with torch.no_grad():
        for t in range(DEC_STEPS):
            lg, cache = transformer.decode_step(
                comm, cfg, params, cache, toks[:, t:t + 1],
                torch.full((DEC_B,), t))
            lgs.append(lg.clone())
    return {"logits": torch.stack(lgs), "cache": cache}


def _task_steps(params, tokens):
    """`make_serve_steps` on CELL over a 2x2 mesh made in this 4-rank
    run: the prefill's logits, each teacher-forced decode step's, the
    cache's local shapes and specs; back to 1x4 after."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import config as mconfig
    cfg = _cfg(QWEN)
    mesh = make_mesh(*STEPS_DIMS)
    mconfig.SHAPES[CELL] = CELL_SPEC
    pre, dec, (cshapes, cspecs), _, ss = build.make_serve_steps(cfg, mesh,
                                                                CELL)
    cache = transformer.map_params(
        lambda t: torch.zeros(t.shape, dtype=t.dtype), cshapes)
    B = tokens.shape[0]
    out = {"prefill": pre(params, {"tokens": tokens}), "logits": [],
           "shapes": transformer.map_params(lambda t: tuple(t.shape),
                                            cshapes),
           "specs": cspecs, "seq_shards": ss}
    for t in range(DEC_STEPS):
        lg, cache = dec(params, cache, {"tokens": tokens[:, t:t + 1],
                                        "positions": np.full((B,), t)})
        out["logits"].append(lg.clone())
    make_mesh(1, 4)
    return out


def _task_c7(seed, x):
    """Fault C7's path: attention="ring" on a 2x1 mesh, x (B, L, d)
    sharded over `data` by sequence with its global positions: this
    rank's rows of the ring layer; on 1x2 (a data axis of one PE) the
    ring and the mono attention over the whole of x."""
    import dataclasses
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel.comm import AxisSpec, Comm
    cfg = _cfg(QWEN)
    ring = dataclasses.replace(cfg, attention="ring")
    x = torch.as_tensor(x)
    B, Lg = x.shape[:2]
    pos = torch.arange(Lg).expand(B, Lg)
    out = {}
    mesh = make_mesh(2, 1)
    ls, d = Lg // 2, mesh.axis_index("data")
    rows = slice(d * ls, (d + 1) * ls)
    p = transformer.init_params(cfg, seed=seed, device="cpu")
    with torch.no_grad():
        out["data2"] = L.attention(Comm(AxisSpec()), ring,
                                   p["layers"][0]["attn"], x[:, rows],
                                   pos[:, rows])
    make_mesh(1, 2)
    p = transformer.init_params(cfg, seed=seed, device="cpu", tp=2)
    with torch.no_grad():
        out["ring"], out["mono"] = (
            L.attention(Comm(AxisSpec()), c, p["layers"][0]["attn"], x, pos)
            for c in (ring, cfg))
    return out


def _local(gp, cfg, dims, r):
    return convert.local_shards(gp, cfg, RankMesh(("data", "model"), dims, r))


@pytest.fixture(scope="module")
def port(inputs, ref_run):
    """Every rank's results: one spawn of 2 ranks (1x2) and one of 4
    (1x4, and 2x2 for the serve steps)."""
    tie = np.zeros((4, 16), np.float32)
    tie[0, [3, 11]] = 5.0        # the tie straddles the shard boundary -> 3
    tie[1, [9, 13]] = 5.0        # both on shard 1 -> 9
    tie[2, :] = 2.0              # all tied -> 0
    tie[3, 12] = 7.0             # unique max on shard 1 -> 12
    prompts = inputs["prompts"]
    out = {"tie_logits": tie}
    for n in (2, 4):
        args = []
        for r in range(n):
            tasks = []
            for tag, arch, dims, ov in ENGINES:
                if dims[1] == n:
                    cfg = _cfg(arch, **ov)
                    local = _local(inputs[f"eng/{tag}"], cfg, dims, r)
                    tasks.append((tag, "engine", (cfg, local, prompts)))
                    if n == 2:
                        tasks.append(("fault", "fault",
                                      (cfg, local, prompts[0])))
            if n == 2:
                tasks.append(("tie", "tie", (tie,)))
                for arch in DECODE:
                    gp, toks = inputs[f"dec/{arch}"]
                    tasks.append((arch, "decode", (arch, _local(
                        gp, _cfg(arch), (1, 2), r), toks)))
                tasks.append(("c7", "c7", (C7_SEED, inputs["c7/x"])))
            else:
                gp, toks = inputs["steps"]
                tasks.append(("steps", "steps", (_local(
                    gp, _cfg(QWEN), STEPS_DIMS, r), toks)))
            args.append((tasks,))
        out[n] = build.shard_mapped(rank_body, (1, n), args, device="cpu",
                                    slot_bytes=SLOT)
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4, 8, 16])
def test_kv_cache_plan_equals_the_reference(tp):
    """For the full config of every arch with attention heads: None
    where the reference's is None, else ndk, store_idx and q2slot
    exactly."""
    from repro.configs import get_config as jget
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    n = 0
    for arch in ARCHS:
        cfg = get_config(arch)
        if not cfg.n_heads:
            continue
        want, got = JL.kv_cache_plan(jget(arch), tp), L.kv_cache_plan(cfg, tp)
        assert (want is None) == (got is None), arch
        if want is not None:
            n += 1
            assert got[0] == want[0], arch
            for a, b in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(a, b, err_msg=arch)
                assert a.dtype == b.dtype
    # at tp 2 every arch's kv heads divide over the ranks: no plan
    assert (n > 0) == (tp > 2)


def test_padded_plan_of_the_override_at_1x4():
    """`n_heads=6, n_kv_heads=2` over 4 ranks: ndk 2, ranks 0, 2 and 3
    padded (their q heads read one kv head), rank 3's two q heads ghosts
    of head 5; and the cache stores ndk heads a rank."""
    from repro_torch.models import layers as L
    cfg = _cfg(QWEN, **OVERRIDE)
    ndk, store, q2 = L.kv_cache_plan(cfg, 4)
    assert ndk == 2
    assert store.tolist() == [[0, 0], [0, 1], [1, 1], [1, 1]]
    assert q2.tolist() == [[0, 0], [0, 1], [0, 0], [0, 0]]
    assert L.init_attn_cache(cfg, 4, 3, 8, "cpu")["k"].shape == (3, 8, 2, 16)


@pytest.mark.parametrize("rank", range(4))
def test_plan_tensors_are_built_once_a_rank(rank):
    """The decode path's index tensors and ghost mask of the override at
    1x4: the plan's rows of `rank`, the mask 0 on rank 3's two ghost
    heads, and one copy each, reused by every later call."""
    from repro_torch.models import layers as L
    cfg = _cfg(QWEN, **OVERRIDE)
    _, store, q2 = L.kv_cache_plan(cfg, 4)
    dev = torch.device("cpu")
    sidx, slot = L._plan_tensors(cfg, 4, rank, dev)
    assert sidx.tolist() == store[rank].tolist()
    assert slot.tolist() == q2[rank].tolist()
    assert L._plan_tensors(cfg, 4, rank, dev)[0] is sidx
    mask = L._ghost_mask(cfg, 4, rank, torch.float32, dev)
    assert mask.tolist() == ([0.0, 0.0] if rank == 3 else [1.0, 1.0])
    assert L._ghost_mask(cfg, 4, rank, torch.float32, dev) is mask


def test_tie_break_across_shards(port):
    """Ties break to the lowest GLOBAL index on 1x2 ranks, as argmax over
    the whole vocabulary: 3, 9, 0, 12 on every rank."""
    for got in port[2]:
        assert got["tie"].tolist() == [3, 9, 0, 12] == \
            np.argmax(port["tie_logits"], -1).tolist()


def _engine_ranks(port, tag):
    n = {e[0]: e[2][1] for e in ENGINES}[tag]
    return [got[tag] for got in port[n]]


@pytest.mark.parametrize("tag", [e[0] for e in ENGINES])
def test_engine_pages_equal_the_reference(ref, port, tag):
    """The rank's page (its pool's kv heads) and the page count sized
    from it equal the reference engine's."""
    for eng in _engine_ranks(port, tag):
        assert eng["page_bytes"] == int(ref[f"eng/{tag}/page_bytes"])
        assert eng["num_pages"] == int(ref[f"eng/{tag}/num_pages"])


@pytest.mark.parametrize("tag", [e[0] for e in ENGINES])
def test_engine_matches_the_reference_engine(ref, port, tag):
    """Tokens equal to the reference engine's on the same mesh, captured
    logits (the whole vocabulary) at rtol 1e-4 / atol 1e-5."""
    eng = _engine_ranks(port, tag)[0]
    for i, (tok, lg) in enumerate(zip(eng["tokens"], eng["logits"])):
        np.testing.assert_array_equal(tok, ref[f"eng/{tag}/tokens/{i}"])
        np.testing.assert_allclose(lg, ref[f"eng/{tag}/logits/{i}"],
                                   err_msg=f"request {i}", **TOL)


@pytest.mark.parametrize("tag", [e[0] for e in ENGINES])
def test_engine_ranks_agree_and_batched_equals_alone(port, tag):
    """Every rank's results equal rank 0's; each request alone (in slot
    0, every other row inactive) gives its batched tokens and logits bit
    for bit, whatever its slot in the batch."""
    ranks = _engine_ranks(port, tag)
    lead = ranks[0]["results"]
    for r, eng in enumerate(ranks):
        assert sorted(eng["results"]) == sorted(lead)
        for rid, toks in eng["results"].items():
            np.testing.assert_array_equal(toks, lead[rid],
                                          err_msg=f"rank {r} rid {rid}")
        for (a_tok, a_lg), tok, lg in zip(eng["alone"], eng["tokens"],
                                          eng["logits"]):
            np.testing.assert_array_equal(a_tok, tok)
            np.testing.assert_array_equal(a_lg, lg)


def test_request_alone_in_slot_0_equals_batched_in_slot_2_at_tp2(port):
    """Fault C8: on the 1x2 engine (tp 2: the smoke MLP's 48 columns a
    rank, 3 slots) request 2 runs in slot 2 of the batch and alone in
    slot 0; its tokens and every step's logits are equal bit for bit on
    every rank (with the CPU's vectorized `F.silu` its last bits
    depended on its slot)."""
    for r, eng in enumerate(_engine_ranks(port, "qwen2")):
        a_tok, a_lg = eng["alone"][2]
        np.testing.assert_array_equal(a_tok, eng["tokens"][2],
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(a_lg, eng["logits"][2],
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 48), (5, 48), (3, 40), (4, 1000)])
def test_mlp_silu_of_a_row_does_not_depend_on_the_rows_beside_it(shape,
                                                                 dtype):
    """Fault C8's repair: on the CPU the MLP's and experts' silu gives
    each row of a batch bit for bit what it gives that row alone, and
    stays within one rounding of `F.silu` (f32 compute for bf16)."""
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(8)
    x = (3 * torch.randn(shape, generator=gen)).to(dtype)
    got = L._silu(x)
    for r in range(shape[0]):
        assert torch.equal(got[r], L._silu(x[r:r + 1])[0]), r
    want = torch.nn.functional.silu(x.double()).to(dtype)
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(),
                               rtol=2 * torch.finfo(dtype).eps, atol=0)


def test_engine_on_a_mesh_refuses_a_data_axis_and_a_pe_failure(port):
    """The reference's ValueError for a data axis or a pod; a PE failure
    in a step on a mesh drains every rank alike, as the reference's
    engine drains on any mesh."""
    from repro_torch.serve.engine import ServeEngine
    cfg = _cfg(QWEN)
    for mesh in (RankMesh(("data", "model"), (2, 1), 0),
                 RankMesh(("pod", "data", "model"), (2, 1, 1), 0)):
        with pytest.raises(ValueError, match=r"\(1, tp\) mesh"):
            ServeEngine(cfg, mesh, device="cpu")
    for got in port[2]:
        assert got["fault"] == port[2][0]["fault"]
        assert got["fault"]["faulted"] and got["fault"]["requeued"] == [0]
        assert got["fault"]["live"] == 0


@pytest.mark.parametrize("arch", DECODE)
def test_decode_step_at_tp2_matches_reference(ref, port, arch):
    """4 teacher-forced decode steps at 1x2: each rank's logits of every
    step and every leaf of its final cache against that device's."""
    want_lg = ref[f"dec/{arch}/logits"]
    want_cache = _unflat(ref, f"dec/{arch}/cache")
    for r, got in enumerate(port[2]):
        res = got[arch]
        np.testing.assert_allclose(res["logits"].numpy(), want_lg[r],
                                   err_msg=f"rank {r} logits", **TOL)
        cache = _stacked_cache(res["cache"])
        want = {k: v[r] for k, v in _flat(want_cache, "", {}).items()}
        assert sorted("/" + k for k in cache) == sorted(want)
        for k, v in cache.items():
            np.testing.assert_allclose(v, want["/" + k],
                                       err_msg=f"rank {r} {k}", **TOL)


@pytest.mark.parametrize("arch", DECODE)
def test_cache_specs_equal_the_reference_rules(arch):
    """`sharding.cache_specs` on the port's cache tree (one dict per
    layer) gives, leaf by leaf, the reference's spec on its stacked
    tree without the stacked dim."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jsmoke
    from repro.models import transformer as JT
    from repro.parallel import sharding as JS
    from repro_torch.parallel import sharding as S
    jcfg = jsmoke(arch, dtype=jnp.float32)
    jshapes = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 4, 8, 1))
    jspecs = JS.cache_specs(jcfg, jshapes, JS.MeshAxes(), 1)
    cache = transformer.init_cache(_cfg(arch), 2, 4, 8, device="meta")
    specs = S.cache_specs(_cfg(arch), cache, S.MeshAxes())
    got = 0
    for group, layers in specs.items():
        for spec in layers:
            for leaf, s in spec.items():
                want = tuple(jspecs[group][leaf])[1:]
                assert s == want, (group, leaf, s, want)
                got += 1
    assert got == sum(len(layers[0]) * len(layers)
                      for layers in cache.values())
    # the sequence-sharded cache: the batch replicated, the sequence over
    # data (conv and ssm replicated there)
    jshapes = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 1, 8, 2))
    jspecs = JS.cache_specs(jcfg, jshapes, JS.MeshAxes(), 2)
    cache = transformer.init_cache(_cfg(arch), 2, 1, 8, 2, device="meta")
    specs = S.cache_specs(_cfg(arch), cache, S.MeshAxes(), seq_shards=2)
    for group, layers in specs.items():
        for spec in layers:
            for leaf, s in spec.items():
                assert s == tuple(jspecs[group][leaf])[1:], (group, leaf, s)
    assert any(s[1] == "data" for layers in specs.values()
               for spec in layers for s in spec.values()) \
        == (arch != "mamba2-2.7b")


def test_make_serve_steps_matches_the_reference(ref, port):
    """`make_serve_steps` on a small decode cell (4 sequences of 8
    slots) patched into both SHAPES, on 2x2: each rank's prefill logits
    and every teacher-forced decode step's against the vocabulary and
    batch slice of the reference's global logits, the cache's local
    shapes and specs equal to the reference's; seq_shards 1."""
    B = CELL_SPEC["global_batch"]
    for r, got in enumerate(port[4]):
        res = got["steps"]
        d, m = divmod(r, STEPS_DIMS[1])
        bl = B // STEPS_DIMS[0]
        vl = res["prefill"].shape[-1]
        rows, cols = slice(d * bl, (d + 1) * bl), slice(m * vl, (m + 1) * vl)
        np.testing.assert_allclose(res["prefill"].numpy(),
                                   ref["steps/prefill"][rows, :, cols],
                                   err_msg=f"rank {r} prefill", **TOL)
        np.testing.assert_allclose(
            torch.stack(res["logits"]).numpy(),
            ref["steps/logits"][:, rows, :, cols],
            err_msg=f"rank {r} decode", **TOL)
        assert res["seq_shards"] == int(ref["steps/seq_shards"]) == 1
        for group, layers in res["shapes"].items():
            for leaf in layers[0]:
                # the reference's local leaf is stacked (layers, B, S, H,
                # hd); the port's is one layer's
                want = tuple(ref[f"steps/shape/{group}/{leaf}"][1:].tolist())
                assert all(tuple(c[leaf]) == want for c in layers)
                want_spec = eval(str(ref[f"steps/spec/{group}/{leaf}"]))
                assert all(s[leaf] == tuple(want_spec)[1:]
                           for s in res["specs"][group])


def test_make_serve_steps_refuses_a_batch_below_the_data_size():
    """long_500k's batch of 1 over a data axis of 2 shards the cache's
    sequence, as the reference's `make_serve_steps`: seq_shards 2, every
    rank's cache of batch 1 and 524288 / 2 slots a layer, the reference's
    `init_cache(seq_shards=2)` shapes and `cache_specs` rules; a prefill
    cell has no cache."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jsmoke
    from repro.models import transformer as JT
    from repro.parallel import sharding as JS
    from repro_torch.models.config import SHAPES
    _, _, (cshapes, cspecs), _, ss = build.make_serve_steps(
        _cfg(QWEN), build.mesh_of(2, 1), "long_500k")
    assert ss == 2
    jcfg = jsmoke(QWEN, dtype=jnp.float32)
    jshapes = jax.eval_shape(lambda: JT.init_cache(
        jcfg, 1, 1, SHAPES["long_500k"]["seq_len"], 2))
    jspecs = JS.cache_specs(jcfg, jshapes, JS.MeshAxes(), 2)
    for i, (c, s) in enumerate(zip(cshapes["layers"], cspecs["layers"])):
        for leaf in ("k", "v"):
            assert tuple(c[leaf].shape) == jshapes["layers"][leaf].shape[1:]
            assert c[leaf].shape[:2] == (1, 524288 // 2)
            assert s[leaf] == tuple(jspecs["layers"][leaf])[1:] \
                == (None, "data", "model", None)
    pre, dec, (cshapes, cspecs), _, ss = build.make_serve_steps(
        _cfg(QWEN), build.mesh_of(1, 2), "prefill_32k")
    assert cshapes is None and cspecs is None and ss == 1


def test_serve_launcher_2x2_matches_reference_launcher(ref_run):
    """`launch.serve --data 2 --model 2 --smoke` (the dense-cache loop,
    the batch over data) against the reference's launcher with the same
    flags, token for token, both from the reference launcher's seed-0
    global parameters and in f32 compute (smoke_config patched on both
    sides)."""
    (_, proc), d = ref_run
    want = _wait(proc, d, "launch.npz", "LAUNCH-OK")
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    cfg = _cfg(QWEN)
    params = convert.params_from_jax(_unflat(want, "params"), cfg)
    orig = configs.smoke_config
    with mock.patch.object(configs, "smoke_config",
                           lambda a, **kw: orig(a, dtype=torch.float32,
                                                **kw)):
        got = launch_serve.run(LAUNCH_ARGV + ["--device", "cpu"],
                               params=params)
    assert got.shape == (4, 4)
    np.testing.assert_array_equal(got, want["tokens"])


def _option_strings(module):
    """Every option string a reference launcher's --help lists (on lines
    wide enough that argparse wraps none)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit), \
            mock.patch.dict(os.environ, COLUMNS="10000"):
        module.main(["--help"])
    return set(re.findall(r"(?<![\w-])(--[a-z][a-z0-9-]*)", buf.getvalue()))


def test_launchers_accept_every_reference_flag():
    """Fault C6: each option string of the reference's train and serve
    parsers is one of the port's parser of the same name; --comm shmem
    and --comm xla parse, and the serve launcher runs under --comm xla
    (the dense-cache loop, as the reference's)."""
    from repro.launch import serve as jserve
    from repro.launch import train as jtrain
    from repro_torch.launch import serve as pserve
    from repro_torch.launch import train as ptrain
    for jmod, ap in ((jtrain, ptrain._parser()), (jserve, pserve._parser())):
        want = _option_strings(jmod) - {"--help"}
        assert {"--comm", "--data", "--model"} <= want
        assert want <= set(ap._option_string_actions), \
            want - set(ap._option_string_actions)
    for comm in ("shmem", "xla"):
        assert ptrain.parse_args(["--arch", QWEN, "--comm", comm]).comm \
            == comm
    got = pserve.run(["--arch", QWEN, "--smoke", "--device", "cpu",
                      "--comm", "xla", "--batch", "2", "--prompt-len", "3",
                      "--tokens", "2"])
    assert got.shape == (2, 2)


def test_ring_attention_on_a_data_axis_names_its_slice(ref, port):
    """Fault C7's path: `attention="ring"` over a data axis of 2 PEs is
    the reference's sequence-sharded ring: each rank's rows of x, at
    their global positions, within RING_SPMD's 2e-5 of the reference's
    ring layer on 2x1; over a data axis of one PE it is the mono
    attention, bit for bit, as in the reference."""
    want = ref["c7/ring"]
    ls = want.shape[1] // 2
    for r, got in enumerate(port[2]):
        res = got["c7"]
        err = np.abs(res["data2"].numpy()
                     - want[:, r * ls:(r + 1) * ls]).max()
        assert err < 2e-5, (r, err)
        assert torch.equal(res["ring"], res["mono"])
