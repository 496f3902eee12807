"""The port's training path against the JAX package on the CPU, on the
same numpy inputs: the data pipeline, AdamW (f32, bf16 and int8
moments, and which leaves decay), the cross-entropy, `train_loss` and its
gradients, a whole train step (default and fused sync, 1 and 2
microbatches), the fused-bucket plan, the launcher and checkpoints.

The JAX functions run outside shard_map through a `Comm` whose model axis
is None, except the train step, which runs in shard_map on a 1x1 mesh as
`tests/test_models.py` runs it.  f32 compute (the smoke config with
dtype float32) where the point is the algorithm."""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import smoke_config as jax_smoke
from repro.core import heap as jheap
from repro.ckpt import manager as jckpt
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import build
from repro.launch.mesh import make_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.parallel.comm import AxisSpec as JAxisSpec
from repro.parallel.comm import Comm as JComm
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.ckpt import manager as ckpt
from repro_torch.configs import smoke_config
from repro_torch.core import Profiler, Tuner, heap
from repro_torch.core.heap import tree_flatten, tree_unflatten
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as train_mod
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.parallel.comm import Comm
from repro_torch.train import optimizer as opt
from repro_torch.tools.tracereport import validate_metrics, validate_trace
from repro_torch.train import step as tstep

JCFG = jax_smoke("qwen2-0.5b", dtype=jnp.float32)
CFG = smoke_config("qwen2-0.5b", dtype=torch.float32)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


def jcomm():
    return JComm(JAxisSpec(model=None), "xla")


def jparams_np(seed):
    """Reference params as numpy, every leaf moved off its init value (so
    norms and biases are nonzero, the leaves the decay rule is about)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        JT.init_params(jax.random.key(seed), JCFG, 1))
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(
            np.float32), tree)


def grads_np(tree, rng):
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)


def batch_np(seed=0, seq=32, batch=4):
    return JSyntheticLM(JCFG.vocab, seq, batch, seed=seed).batch(0)


def assert_trees_close(port_tree, jax_tree, **tol):
    got = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), err_msg=str(k),
                                   **tol)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab=100, seq_len=16, global_batch=4, seed=3),
    dict(vocab=151936, seq_len=128, global_batch=8),
    dict(vocab=50, seq_len=8, global_batch=2, frames_dim=6),
    dict(vocab=50, seq_len=8, global_batch=2, frontend_tokens=3),
])
def test_synthetic_lm_batches_identical(kw):
    a, b = SyntheticLM(**kw), JSyntheticLM(**kw)
    for step in (0, 5):
        got, want = a.batch(step), b.batch(step)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_prefetch_iterator():
    p = SyntheticLM(vocab=50, seq_len=8, global_batch=2, seed=0)
    it = p.iterate(start_step=3)
    for step in (3, 4, 5):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      p.batch(step)["tokens"])
    it.close()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _moments(state, params, key):
    """The port's per-leaf moments `key` as a tree in the JAX layout."""
    leaves, treedef = tree_flatten(params)
    return params_to_jax(
        tree_unflatten(treedef, [mv[key] for mv in state["mv"]]), CFG)


def _adamw_both(moment_dtype, monkeypatch=None, naive_decay=False):
    if naive_decay:
        monkeypatch.setattr(
            opt, "decay_flags",
            lambda p: [l.dim() >= 2 for l in tree_flatten(p)[0]])
    jp = jparams_np(0)
    cfg = opt.AdamWConfig(moment_dtype=moment_dtype)
    jcfg = jopt.AdamWConfig(moment_dtype=moment_dtype)
    params = params_from_jax(jp, CFG)
    jparams = jax.tree.map(jnp.asarray, jp)
    st, jst = opt.init_state(params, cfg), jopt.init_state(jparams, jcfg)
    rng = np.random.default_rng(1)
    for _ in range(3):
        g = grads_np(jp, rng)
        params, st = opt.apply_updates(params, params_from_jax(g, CFG), st,
                                       cfg)
        jparams, jst = jopt.apply_updates(
            jparams, jax.tree.map(jnp.asarray, g), jst, jcfg)
    return params, st, jparams, jst


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16"])
def test_apply_updates_matches_reference(moment_dtype):
    """Three AdamW steps on the smoke model's tree with nonzero norms and
    biases.  rtol 1e-6: `1 - b**t` comes from two pow implementations
    (one ulp apart on some t); weight decay moves a leaf by lr * wd =
    3e-5 of itself per step, 30x the tolerance.  The moments are equal."""
    params, st, jparams, jst = _adamw_both(moment_dtype)
    assert_trees_close(params_to_jax(params, CFG), jparams, rtol=1e-6,
                       atol=0)
    assert int(st["step"]) == int(jst["step"]) == 3
    for key in ("m", "v"):
        want = jax.tree.map(lambda d: d[key], jst["mv"],
                            is_leaf=lambda d: isinstance(d, dict)
                            and key in d)
        assert_trees_close(_moments(st, params, key), want, rtol=0, atol=0)


def test_apply_updates_int8_matches_reference():
    """int8 moments quantise each leaf in 128-element blocks, so the
    blocks follow the layout: the reference's span a stacked per-layer
    leaf across layers, the port's one layer's leaf.  On a tree whose
    layout is the same on both sides the results agree (rtol as above)
    and the int8 codes and scales are equal."""
    rng = np.random.default_rng(5)
    shapes = {"w": (16, 160), "b": (200,), "e": (3, 50, 7)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    cfg = opt.AdamWConfig(moment_dtype="int8")
    jcfg = jopt.AdamWConfig(moment_dtype="int8")
    params = {k: torch.from_numpy(v) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    st, jst = opt.init_state(params, cfg), jopt.init_state(jparams, jcfg)
    for _ in range(3):
        g = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
             for k, s in shapes.items()}
        params, st = opt.apply_updates(
            params, {k: torch.from_numpy(v) for k, v in g.items()}, st, cfg)
        jparams, jst = jopt.apply_updates(
            jparams, {k: jnp.asarray(v) for k, v in g.items()}, jst, jcfg)
    for i, k in enumerate(sorted(shapes)):
        np.testing.assert_allclose(params[k].numpy(),
                                   np.asarray(jparams[k]), rtol=1e-6)
        for mk in ("m", "v"):
            for part in ("q", "scale"):
                np.testing.assert_array_equal(
                    st["mv"][i][mk][part].numpy(),
                    np.asarray(jst["mv"][k][mk][part]))


def _int8_codes_by_reference_leaf(params, st):
    """The port's int8 moment groups keyed by the reference's leaf path
    ("layers/attn/wq" for the group of every layer's wq)."""
    names = [n for n, _ in ckpt._leaf_paths(params)]
    out = {}
    for group, mv in zip(opt.moment_groups(params, "int8"), st["mv"]):
        parts = names[group[0]].split("/")
        key = "/".join(parts[:1] + parts[2:]) if parts[0] == "layers" \
            else names[group[0]]
        out[key] = mv
    return out


def _reference_codes(jst):
    flat = jax.tree_util.tree_flatten_with_path(
        jst["mv"], is_leaf=lambda d: isinstance(d, dict) and "m" in d)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): mv
            for path, mv in flat}


def test_apply_updates_int8_matches_reference_on_the_stacked_layout():
    """Fault C2: int8 moments quantise a per-layer leaf over the
    concatenation of its layers, the reference's stacked [n_layers, ...]
    leaf, in 128-element blocks.  On the smoke model (d 48, where a
    per-layer leaf is no multiple of 128) three steps through both
    packages give equal int8 codes and scales and params within rtol
    1e-6 (`test_apply_updates_matches_reference`'s tolerance)."""
    params, st, jparams, jst = _adamw_both("int8")
    assert_trees_close(params_to_jax(params, CFG), jparams, rtol=1e-6,
                       atol=0)
    got, want = _int8_codes_by_reference_leaf(params, st), \
        _reference_codes(jst)
    assert sorted(got) == sorted(want)
    for key in want:
        for mk in ("m", "v"):
            for part in ("q", "scale"):
                np.testing.assert_array_equal(
                    got[key][mk][part].numpy(),
                    np.asarray(want[key][mk][part]), err_msg=key)


def test_per_layer_int8_blocks_would_differ_from_the_reference(monkeypatch):
    """Fault C2 as it was: quantising each layer's leaf on its own (one
    moment group per leaf) puts the 128-element blocks elsewhere than the
    reference's stacked leaf, so codes, scales and params differ."""
    layer0 = params_from_jax(jparams_np(0), CFG)["layers"][0]
    assert any(l.numel() % 128 for l in tree_flatten(layer0)[0])
    monkeypatch.setattr(
        opt, "moment_groups",
        lambda p, dtype, local_global_period=None:
        [[i] for i in range(len(tree_flatten(p)[0]))])
    params, st, jparams, jst = _adamw_both("int8")
    want = _reference_codes(jst)
    names = [n for n, _ in ckpt._leaf_paths(params)]
    differ = 0
    for key, mv in want.items():
        if not key.startswith("layers/"):
            continue
        parts = key.split("/")
        idx = [i for i, n in enumerate(names)
               if n.split("/")[0] == "layers"
               and "/".join(n.split("/")[2:]) == "/".join(parts[1:])]
        scales = np.concatenate([st["mv"][i]["m"]["scale"].numpy().ravel()
                                 for i in idx])
        ref_scales = np.asarray(mv["m"]["scale"]).ravel()
        differ += scales.shape != ref_scales.shape \
            or not np.array_equal(scales, ref_scales)
    assert differ > 0
    got = params_to_jax(params, CFG)["layers"]
    assert any(not np.allclose(a, np.asarray(b), rtol=1e-6, atol=0)
               for a, b in zip(jax.tree.leaves(got),
                               jax.tree.leaves(jparams["layers"])))


def test_plain_ndim_rule_would_miss_the_stacked_decay(monkeypatch):
    """Fault 2: deciding decay by the port's own leaf rank skips ln1,
    ln2 and the qkv biases, which the reference decays (2-D once
    stacked), so the result leaves the reference's tolerance."""
    params, _, jparams, _ = _adamw_both("f32", monkeypatch,
                                        naive_decay=True)
    got = params_to_jax(params, CFG)
    for name in ("ln1", "ln2"):
        assert not np.allclose(got["layers"][name],
                               np.asarray(jparams["layers"][name]),
                               rtol=1e-6, atol=0)
    assert not np.allclose(got["layers"]["attn"]["bq"],
                           np.asarray(jparams["layers"]["attn"]["bq"]),
                           rtol=1e-6, atol=0)


def test_decay_flags_follow_the_stacked_layout():
    jp = jparams_np(0)
    params = params_from_jax(jp, CFG)
    ref_ndim = {"/".join(str(getattr(k, "key", k)) for k in path): a.ndim
                for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    names = [n for n, _ in ckpt._leaf_paths(params)]
    flags = opt.decay_flags(params)
    assert len(names) == len(flags) == len(tree_flatten(params)[0])
    for name, flag in zip(names, flags):
        parts = name.split("/")
        key = "/".join(parts[:1] + parts[2:]) if parts[0] == "layers" \
            else name
        assert flag == (ref_ndim[key] >= 2), name
    assert flags[names.index("layers/0/ln1")]
    assert not flags[names.index("final_norm")]


def test_int8_roundtrip_error_bounded():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1000,)).astype(np.float32)
    enc = opt._q_encode(torch.from_numpy(x), "int8")
    jenc = jopt._q_encode(jnp.asarray(x), "int8")
    np.testing.assert_array_equal(enc["q"].numpy(), np.asarray(jenc["q"]))
    np.testing.assert_array_equal(enc["scale"].numpy(),
                                  np.asarray(jenc["scale"]))
    dec = opt._q_decode(enc, "int8", (1000,)).numpy()
    assert np.abs(dec - x).max() <= np.abs(x).max() / 127.0 * 1.01 + 1e-7


@pytest.mark.parametrize("moment_dtype", ["bf16", "int8"])
def test_quantized_moments_track_f32(moment_dtype):
    rng = np.random.default_rng(1)
    p0 = torch.from_numpy(rng.standard_normal((16, 160)).astype(np.float32))
    cq = opt.AdamWConfig(moment_dtype=moment_dtype)
    cf = opt.AdamWConfig()
    pq, pf = {"w": p0}, {"w": p0}
    sq, sf = opt.init_state(pq, cq), opt.init_state(pf, cf)
    for _ in range(5):
        g = {"w": torch.from_numpy(
            rng.standard_normal((16, 160)).astype(np.float32) * 0.1)}
        pq, sq = opt.apply_updates(pq, g, sq, cq)
        pf, sf = opt.apply_updates(pf, g, sf, cf)
    rel = ((pq["w"] - pf["w"]).abs().max()
           / ((pf["w"] - p0).abs().max() + 1e-9))
    assert rel < (0.02 if moment_dtype == "bf16" else 0.10), rel


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("softcap", [None, 30.0])
def test_sharded_xent_and_its_gradient(softcap):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 5, 128)) * 5).astype(np.float32)
    targets = rng.integers(0, 128, (2, 5)).astype(np.int32)
    cfg = dataclasses.replace(CFG, final_softcap=softcap)
    jcfg = dataclasses.replace(JCFG, final_softcap=softcap)
    lg = torch.from_numpy(logits).requires_grad_()
    loss = L.sharded_xent(Comm(), cfg, lg, torch.from_numpy(targets)).mean()
    loss.backward()
    loss = loss.detach()
    jl, jg = jax.value_and_grad(lambda x: JL.sharded_xent(
        jcomm(), jcfg, x, jnp.asarray(targets)).mean())(jnp.asarray(logits))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("remat", ["none", "full", "selective"])
def test_train_loss_and_every_gradient_leaf_match_jax(remat):
    """The loss and each gradient leaf (the tied embedding's from the
    gather and the head, rope, the biases, the norms) against
    `jax.value_and_grad(transformer.train_loss)` under the same remat
    policy; with remat "full" the port recomputes every layer in the
    backward pass, with "selective" all of it but the outputs of the
    weight products (the reference's `dots_with_no_batch_dims_saveable`)."""
    jp = jparams_np(1)
    batch = batch_np(1)
    jcfg = dataclasses.replace(JCFG, remat=remat)
    jl, jg = jax.value_and_grad(lambda p: JT.train_loss(
        jcomm(), jcfg, p, jax.tree.map(jnp.asarray, batch)))(
        jax.tree.map(jnp.asarray, jp))
    cfg = dataclasses.replace(CFG, remat=remat)
    loss, grads = tstep.loss_and_grads(
        Comm(), cfg, params_from_jax(jp, CFG),
        tstep.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    assert_trees_close(params_to_jax(grads, CFG), jg, **LOSS_TOL)


def test_selective_remat_gradients_equal_full_remat_bitwise():
    """remat="selective" saves the weight products' outputs that "full"
    recomputes; recomputation is deterministic, so every gradient leaf
    and the loss are the same bits under both (two microbatches, so the
    accumulation runs too)."""
    params = params_from_jax(jparams_np(4), CFG)
    batch = tstep.batch_to_device(batch_np(4), "cpu")
    runs = {r: tstep.loss_and_grads(
        Comm(), dataclasses.replace(CFG, remat=r), params, batch, 2)
        for r in ("full", "selective")}
    (lf, gf), (ls, gs) = runs["full"], runs["selective"]
    assert torch.equal(lf, ls)
    for a, b in zip(tree_flatten(gf)[0], tree_flatten(gs)[0]):
        assert torch.equal(a, b)


def test_selective_remat_saves_the_weight_products_only():
    """Under "selective" the backward recomputes the block but for its
    2-D weight products: counting aten.mm calls, the full policy runs
    them again in the backward's recompute, the selective one does not."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    params = params_from_jax(jparams_np(4), CFG)
    batch = tstep.batch_to_device(batch_np(4), "cpu")
    counts = {}
    for r in ("none", "full", "selective"):
        with Count() as c:
            tstep.loss_and_grads(Comm(), dataclasses.replace(CFG, remat=r),
                                 params, batch)
        counts[r] = c.mm
    # full runs every layer's weight products again; selective reads them
    assert counts["full"] > counts["none"] == counts["selective"]
    assert (counts["full"] - counts["none"]) % CFG.n_layers == 0


def _reference_step(jcfg, grad_rs, jp, batches):
    mesh = make_mesh(1, 1)
    adamw = jopt.AdamWConfig()
    step = jstep.build_train_step(jcfg, JAxisSpec(), "shmem", adamw=adamw,
                                  grad_rs=grad_rs)
    params = jax.tree.map(jnp.asarray, jp)
    state = (jstep.init_fused_opt_state(params, 1) if grad_rs == "fused"
             else jopt.init_state(params, adamw))

    def spec(tree):
        return jax.tree.map(lambda _: P(), tree)

    losses = []
    with jax.set_mesh(mesh):
        jb = jax.tree.map(jnp.asarray, batches[0])
        fn = jax.jit(build.shard_mapped(
            step, mesh, (spec(params), spec(state), spec(jb)),
            (P(), spec(params), spec(state))))
        for b in batches:
            loss, params, state = fn(params, state,
                                     jax.tree.map(jnp.asarray, b))
            losses.append(float(loss))
    return losses


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("grad_rs", [False, "fused"])
def test_train_step_matches_reference(grad_rs, mb):
    """Two whole steps (microbatched gradients, the gradient sync, the
    update) against the reference's build_train_step in shard_map on a
    1x1 mesh: the losses within 1e-5 relative."""
    jp = jparams_np(2)
    batches = [batch_np(s, seq=16) for s in (2, 3)]
    want = _reference_step(dataclasses.replace(JCFG, microbatches=mb),
                           grad_rs, jp, batches)
    cfg = dataclasses.replace(CFG, microbatches=mb)
    step = tstep.build_train_step(cfg, grad_rs=grad_rs)
    params = params_from_jax(jp, CFG)
    state = (tstep.init_fused_opt_state(params, 1) if grad_rs == "fused"
             else opt.init_state(params, opt.AdamWConfig()))
    got = []
    for b in batches:
        loss, params, state = step(params, state, b)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("remat,grad_rs", [("none", False), ("full", False),
                                           ("full", True)])
def test_port_fused_step_equals_default_step_bitwise(remat, grad_rs):
    """grad_rs="fused" (fused_adam_sync: RS + kernel 5 + AG) against the
    allreduce (grad_rs False) or bucketed RS + AG (True) sync then
    apply_updates, over three steps with 2 microbatches: the same
    parameters bit for bit (`test_fused.py::
    test_fused_adam_sync_spmd_bitwise` on one device)."""
    cfg = dataclasses.replace(CFG, microbatches=2, remat=remat)
    p0 = params_from_jax(jparams_np(3), CFG)
    pa, sa = p0, opt.init_state(p0, opt.AdamWConfig())
    pf, sf = p0, tstep.init_fused_opt_state(p0, 1)
    default = tstep.build_train_step(cfg, grad_rs=grad_rs)
    fused = tstep.build_train_step(cfg, grad_rs="fused")
    for s in range(3):
        b = batch_np(s, seq=16)
        la, pa, sa = default(pa, sa, b)
        lf, pf, sf = fused(pf, sf, b)
        assert float(la) == float(lf)
        for x, y in zip(tree_flatten(pa)[0], tree_flatten(pf)[0]):
            assert torch.equal(x, y)


def test_eval_loss_is_the_train_loss_without_a_graph():
    jp = jparams_np(4)
    batch = batch_np(4)
    params = params_from_jax(jp, CFG)
    got = tstep.build_eval_loss(CFG)(params, batch)
    want = JT.train_loss(jcomm(), JCFG, jax.tree.map(jnp.asarray, jp),
                         jax.tree.map(jnp.asarray, batch))
    assert got.grad_fn is None
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


@pytest.mark.parametrize("grad_rs", [False, True])
def test_fused_grad_sync_equals_unfused(grad_rs):
    rng = np.random.default_rng(4)
    grads = {f"g{i}": torch.from_numpy(
        rng.standard_normal((3, 5)).astype(np.float32)) for i in range(4)}
    mask = {k: True for k in grads}
    comm = Comm(grad_rs=grad_rs)
    a = tstep.fused_grad_sync(comm, grads, mask, fuse=True)
    b = tstep.fused_grad_sync(comm, grads, mask, fuse=False)
    for k in grads:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], grads[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_fused_buckets_and_wd_mask_match_reference(seed):
    """On identical leaf lists (the port's per-layer tree and the
    reference's stacked one bucket differently; the update is
    elementwise, so that changes no value)."""
    rng = np.random.default_rng(seed)
    dts = [(np.float32, torch.float32, jnp.float32),
           (np.float32, torch.bfloat16, jnp.bfloat16)]
    arrays, tl, jl = [], [], []
    for _ in range(40):
        shape = tuple(int(d) for d in rng.integers(1, 40,
                                                   rng.integers(1, 4)))
        npdt, tdt, jdt = dts[int(rng.random() < 0.2)]
        a = rng.standard_normal(shape).astype(npdt)
        tl.append(torch.from_numpy(a).to(tdt))
        jl.append(jnp.asarray(a).astype(jdt))
    bb = 4096
    plan = tstep.plan_fused_buckets(tl, bb)
    assert plan == jstep.plan_fused_buckets(jl, bb) and len(plan) > 3
    for idxs in plan:
        spec = heap.plan_pack([tl[i] for i in idxs], dtype=torch.float32)
        jspec = jheap.plan_pack([jl[i] for i in idxs], dtype=jnp.float32)
        assert spec.offsets == jspec.offsets and spec.total == jspec.total
        np.testing.assert_array_equal(
            tstep._wd_mask(spec, [tl[i].dim() >= 2 for i in idxs],
                           "cpu").numpy(),
            np.asarray(jstep._wd_mask(jspec, [jl[i] for i in idxs])))


@pytest.mark.parametrize("knob", ["pipeline_chunks", "topo", "link",
                                  "embedding", "autotune", "profile"])
def test_build_train_step_refuses_unported_knobs(knob):
    """Every knob is ported (the SPMD backend made the chunking,
    topology, link and embedding knobs live, as the tuner and the
    profiler before them): each rides on the step's Comm, as the
    reference's; on the one-PE data axis no collective runs, so the step
    is bit for bit the plain one (and the services note nothing)."""
    from repro_torch.core import abmodel
    from repro_torch.core.topology import MeshTopology
    service = {"pipeline_chunks": 2, "topo": MeshTopology((2, 2)),
               "link": abmodel.ICI_V5E, "embedding": "snake",
               "autotune": Tuner(), "profile": Profiler(level=2)}[knob]
    p0 = params_from_jax(jparams_np(4), CFG)
    b = batch_np(0, seq=16)
    outs = []
    for kw in ({}, {knob: service}):
        step = tstep.build_train_step(CFG, **kw)
        outs.append(step(p0, opt.init_state(p0, opt.AdamWConfig()), b))
    assert float(outs[0][0]) == float(outs[1][0])
    for x, y in zip(tree_flatten(outs[0][1])[0],
                    tree_flatten(outs[1][1])[0]):
        assert torch.equal(x, y)
    if knob == "profile":
        assert service.samples == []
    elif knob == "autotune":
        assert len(service.db) == 0


@pytest.mark.parametrize("build", [Comm, lambda **kw: tstep.build_train_step(
    CFG, **kw)], ids=["Comm", "build_train_step"])
def test_allreduce_algo_is_not_a_knob_of_the_one_pe_port(build):
    """Every allreduce algorithm is the identity on the one-PE data axis
    (the knob acts on a rank mesh, `tests/test_torch_spmd.py`): accepted
    with the reference's values, and an unknown one is refused."""
    for algo in ("paper", "auto", "rd", "ring", "ring_emb", "hier"):
        assert callable(build(allreduce_algo=algo)) or \
            isinstance(build(allreduce_algo=algo), Comm)
    x = torch.ones(3)
    assert Comm(allreduce_algo="auto").allreduce(x, "data") is x
    with pytest.raises(ValueError, match="allreduce_algo"):
        Comm(allreduce_algo="tree")


def test_fused_sync_needs_f32_moments():
    params = params_from_jax(jparams_np(0), CFG)
    with pytest.raises(ValueError, match="f32 moments"):
        tstep.fused_adam_sync(
            Comm(), params, params, tstep.init_fused_opt_state(params),
            opt.AdamWConfig(moment_dtype="bf16"),
            {k: True for k in params})


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

SMOKE = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu"]


def test_train_launcher_loss_improves():
    losses = train_mod.main(SMOKE + ["--steps", "12", "--seq-len", "64",
                                     "--batch", "8", "--lr", "1e-3"])
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


@pytest.mark.parametrize("flags", [
    ["--data", "2"], ["--model", "2"], ["--pod", "2"], ["--topo", "4x4"],
    ["--embedding", "snake"], ["--autotune"], ["--tuning-db", "db.json"],
    ["--profile-out", "p.json"], ["--trace-out", "t.json"],
    ["--metrics-out", "m.json"], ["--allreduce-algo", "auto"],
    ["--pipeline-chunks", "2"], ["--shard-strategy", "dp_only"],
    ["--remat", "selective"]])
def test_train_launcher_refuses_unported_flags(flags, capsys, tmp_path):
    if flags[0] in ("--data", "--model", "--pod", "--embedding",
                    "--allreduce-algo", "--pipeline-chunks",
                    "--shard-strategy", "--remat"):
        # ported with the SPMD backend: --data/--model/--pod run the step
        # on a mesh of rank processes (tests/test_torch_tp.py and
        # tests/test_torch_pipeline.py hold it to the reference), the rest
        # steer the collectives; --shard-strategy dp_only replicates the
        # parameters (on one device: the same step;
        # tests/test_torch_fsdp.py holds it to the reference on 2x2);
        # --remat selective keeps the weight products' outputs
        losses = train_mod.main(SMOKE + ["--steps", "1", "--seq-len", "16",
                                         "--batch", "2"] + flags)
        assert len(losses) == 1 and np.isfinite(losses).all()
        return
    if flags[0] == "--topo":
        # ported: as the reference's, a layout must cover the data axis
        with pytest.raises(SystemExit, match="covers 16 PEs"):
            train_mod.main(SMOKE + ["--steps", "1"] + flags)
        return
    ported = {"--autotune", "--tuning-db", "--profile-out", "--trace-out",
              "--metrics-out"}
    if flags[0] in ported:
        # the measurement services are ported: the flag runs the step
        # and writes its document, as the reference's launcher does
        flags = flags[:1] + [str(tmp_path / f) for f in flags[1:]]
        losses = train_mod.main(SMOKE + ["--steps", "1", "--seq-len", "16",
                                         "--batch", "2"] + flags)
        assert len(losses) == 1 and np.isfinite(losses).all()
        if len(flags) == 1:
            return
        doc = json.loads((tmp_path / flags[1]).read_text())
        if flags[0] == "--tuning-db":
            assert doc == {"schema": 1, "entries": {}, "links": {}}
        elif flags[0] == "--profile-out":
            assert doc["schema"] == 1
            assert [r["collective"] for r in doc["timeline"]] == \
                ["train_step"]
        elif flags[0] == "--trace-out":
            assert validate_trace(doc) == []
            assert any(e.get("name") == "train_step"
                       for e in doc["traceEvents"])
        else:
            assert validate_metrics(doc) == []
            assert doc["metrics"]["train.steps"]["value"] == 1
            assert doc["metrics"]["train.step_s"]["count"] == 1
        return
    with pytest.raises(SystemExit):
        train_mod.main(SMOKE + ["--steps", "1"] + flags)
    assert "slice 5" in capsys.readouterr().err


def test_train_launcher_services_on_a_mesh(tmp_path):
    """On a --data 2 mesh the one launcher loop runs the measurement
    services in every rank and rank 0 writes its documents; --autotune
    calibrates the data axis once, before the ranks start, so both ranks
    select from the same DB."""
    db, prof, met = (str(tmp_path / f) for f in ("db.json", "p.json",
                                                 "m.json"))
    losses = train_mod.main(SMOKE + [
        "--steps", "2", "--seq-len", "16", "--batch", "2", "--data", "2",
        "--allreduce-algo", "auto", "--autotune", "--tuning-db", db,
        "--profile-out", prof, "--metrics-out", met])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert json.loads(pathlib.Path(db).read_text())["entries"]
    steps = [r for r in json.loads(pathlib.Path(prof).read_text())[
        "timeline"] if r["collective"] == "train_step"]
    assert [r["n_pes"] for r in steps] == [2, 2]
    doc = json.loads(pathlib.Path(met).read_text())
    assert validate_metrics(doc) == []
    assert doc["metrics"]["train.steps"]["value"] == 2
    assert doc["metrics"]["train.step_s"]["count"] == 2


def test_train_launcher_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])


def test_train_checkpoint_resume(tmp_path):
    """Resume continues from the saved step, and the resumed steps give
    the losses of an uninterrupted run bit for bit."""
    run = SMOKE + ["--seq-len", "32", "--batch", "4", "--ckpt-every", "2"]
    train_mod.main(run + ["--steps", "4", "--ckpt-dir", str(tmp_path)])
    assert ckpt.latest_step(tmp_path) == 4
    losses = train_mod.main(run + ["--steps", "6", "--ckpt-dir",
                                   str(tmp_path), "--resume", "auto"])
    straight = train_mod.main(run + ["--steps", "6"])
    assert len(losses) == 2 and losses == straight[4:]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
                       "layers": [{"x": torch.ones(2)}, {"x": torch.zeros(2)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [torch.zeros_like(l) for l in leaves])


def test_checkpoint_save_restore_atomic(tmp_path):
    state = _state()
    ckpt.save(tmp_path, 7, state)
    assert ckpt.latest_step(tmp_path) == 7
    step, restored = ckpt.restore(tmp_path, _zeros_like(state))
    assert step == 7
    for a, b in zip(tree_flatten(restored)[0], tree_flatten(state)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ckpt.save(tmp_path, 9, state)           # LATEST flips atomically
    assert ckpt.latest_step(tmp_path) == 9
    assert not list(tmp_path.glob("tmp-*"))


def test_checkpoint_falls_back_to_the_newest_complete_step(tmp_path):
    state = _state()
    ckpt.save(tmp_path, 3, state)
    d5 = ckpt.save(tmp_path, 5, state)
    leaf = json.loads((d5 / "manifest.json").read_text())["leaves"][0]
    (d5 / leaf["file"]).unlink()            # a partial step-5 dir
    assert ckpt.latest_step(tmp_path) == 3
    assert ckpt.restore(tmp_path, _zeros_like(state))[0] == 3
    for d in tmp_path.glob("step-*"):
        (d / "manifest.json").unlink()
    assert ckpt.latest_step(tmp_path) is None
    with pytest.raises(ckpt.CheckpointError):
        ckpt.restore(tmp_path, _zeros_like(state))


def test_restore_names_a_missing_leaf_and_refuses_a_reshard(tmp_path):
    ckpt.save(tmp_path, 1, {"w": torch.ones(8, 4)})
    with pytest.raises(ckpt.CheckpointError, match="'v'"):
        ckpt.restore(tmp_path, {"v": torch.ones(8, 4)})
    # a changed shape is resharded as the reference's _reshard does it:
    # sliced where the template shrinks a dim, tiled where it grows one
    saved = np.arange(32, dtype=np.float32).reshape(8, 4)
    ckpt.save(tmp_path, 2, {"w": torch.from_numpy(saved)})
    for shape in ((4, 4), (8, 3), (12, 6), (3, 9)):
        got = ckpt.restore(tmp_path, {"w": torch.zeros(shape)})[1]["w"]
        np.testing.assert_array_equal(
            got.numpy(), jckpt._reshard(saved, shape, "w"))
    with pytest.raises(ValueError, match="rank change"):
        ckpt.restore(tmp_path, {"w": torch.zeros(8, 4, 1)})


@pytest.mark.parametrize("async_save", [False, True])
def test_fault_tolerance_manager(tmp_path, async_save):
    ft = ckpt.FaultToleranceManager(str(tmp_path), save_every=2,
                                    async_save=async_save,
                                    step_deadline_s=1e-9)
    state = {"w": torch.ones(2, 2)}
    for s in range(5):
        ft.on_step(s, lambda: state)
        state["w"].add_(1.0)        # the next step changes the state
    ft.finalize(5, lambda: state)
    assert ckpt.latest_step(tmp_path) == 5
    assert len(ft.stragglers) >= 1   # the deadline was epsilon
    saved = np.load(next((tmp_path / "step-00000002").glob("*.npy")))
    np.testing.assert_array_equal(saved, np.full((2, 2), 3.0, np.float32))
