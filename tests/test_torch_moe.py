"""The moe family in the port — granite-moe-3b-a800m (GQA attention, routed
experts in every layer) and deepseek-v3-671b (MLA, a shared expert, its
first layers dense, the MTP head, int8 moments) — on the CPU against the
JAX package, on the same weights (`params_from_jax`) and numpy inputs, in
f32 at rtol 1e-4, atol 1e-5: the MoE layer with and without capacity
drops (its routes exactly), MLA's full-sequence attention and its
absorbed decode with the latent cache, forward (hidden and aux), prefill,
train_loss with every gradient leaf, the decode caches and teacher-forced
decode steps, the parameter round trip, int8 AdamW on the stacked dense
and MoE layers, the load-balance aux, the parameter counts, the
launcher's decode loop and the path without jax.

The JAX functions run outside shard_map through a `Comm` whose model axis
is None (size 1), the port's through its one-device `Comm`."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import smoke_config as jax_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.parallel.comm import AxisSpec as JAxisSpec
from repro.parallel.comm import Comm as JComm
from repro.serve import step as jstep
from repro.train import optimizer as jopt
from repro_torch.ckpt import manager as ckpt
from repro_torch.configs import deepseek_v3_671b, get_config, smoke_config
from repro_torch.core.heap import tree_flatten
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.parallel.comm import Comm
from repro_torch.serve import step as sstep
from repro_torch.train import optimizer as opt
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
GRANITE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-v3-671b"
ARCHS = [GRANITE, DEEPSEEK]
TOL = dict(rtol=1e-4, atol=1e-5)
NORMS = ("ln1", "ln2", "ln", "q_norm", "kv_norm", "final_norm")
JDT = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float32): torch.float32}


def jcomm():
    return JComm(JAxisSpec(model=None), "xla")


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, **kw):
    np.testing.assert_allclose(a.detach().float().numpy(),
                               np.asarray(b, np.float32), **{**TOL, **kw})


def configs(arch, **kw):
    """(reference config, port config) of `arch`'s smoke size in f32."""
    return (jax_smoke(arch, dtype=jnp.float32, **kw),
            smoke_config(arch, dtype=torch.float32, **kw))


def _jax_weights(jcfg, seed):
    """The reference's smoke weights as numpy, every norm moved off zero
    so that each term is exercised."""
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda k: JT.init_params(k, jcfg, 1))(jax.random.key(seed)))
    rng = np.random.RandomState(seed)

    def move(path, a):
        if str(getattr(path[-1], "key", "")) in NORMS:
            return (rng.randn(*a.shape) * .1).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(move, jp)


@pytest.fixture(scope="module")
def weights():
    """{arch: (reference numpy weights, the port's copy)}."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = configs(arch)
        jp = _jax_weights(jcfg, 3)
        out[arch] = jp, params_from_jax(jp, cfg)
    return out


def _tokens(vocab, B, seq, seed=1):
    return np.random.default_rng(seed).integers(
        1, vocab, size=(B, seq)).astype(np.int32)


def per_layer(tree, group):
    """One of the reference's stacked per-layer trees as a list of leaf
    dicts, one per layer."""
    n = jax.tree.leaves(tree[group])[0].shape[0]
    return [jax.tree.map(lambda a: a[i], tree[group]) for i in range(n)]


def _assert_trees_close(got, want, **kw):
    got = jax.tree_util.tree_flatten_with_path(got)[0]
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   err_msg=str(k), **{**TOL, **kw})


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _reference_keep(tope, n_experts, cap):
    """keep by the reference's rule, in numpy: each pick's rank among the
    earlier picks of its expert in token-major order, under `cap`."""
    e = np.asarray(tope).reshape(-1)
    ranks = np.cumsum(np.eye(n_experts, dtype=np.int64)[e], 0) - 1
    return ranks[np.arange(e.size), e] < cap


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,seq,capacity_factor,drops", [
    (2, 9, 1.25, True), (1, 3, 1.25, True),     # capacity 5 and 1
    (2, 9, None, False)])                      # capacity T: none dropped
def test_moe_matches_jax(weights, arch, B, seq, capacity_factor, drops):
    """`moe` alone on one layer's weights: the routes (top-k experts and
    the keep flags) exactly the reference's, out and aux at the
    tolerance; with capacity_factor n_experts / top_k the capacity is T
    and nothing drops."""
    jcfg, cfg = configs(arch)
    mo = cfg.moe
    cf = capacity_factor or mo.n_experts / mo.top_k
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=cf))
    jp, params = weights[arch]
    x = np.random.default_rng(7).standard_normal(
        (B, seq, cfg.d_model)).astype(np.float32)
    jtopk, routes = [], []
    real_topk, real_route = jax.lax.top_k, L.moe_route

    def jspy(g, k):
        out = real_topk(g, k)
        jtopk.append(np.asarray(out[1]))
        return out

    def spy(*a):
        out = real_route(*a)
        routes.append(out)
        return out

    with mock.patch.object(jax.lax, "top_k", jspy):
        jout, jaux = JL.moe(jcomm(), jcfg,
                            jax.tree.map(jnp.asarray, per_layer(
                                jp, "layers")[0]["moe"]), jnp.asarray(x))
    with mock.patch.object(L, "moe_route", spy):
        out, aux = L.moe(Comm(), cfg, params["layers"][0]["moe"], t(x))
    (_, _, tope, _, keep, cap), = routes
    T_ = B * seq
    assert cap == max(1, int(cf * T_ * mo.top_k / mo.n_experts))
    np.testing.assert_array_equal(tope.numpy(), jtopk[0])
    want_keep = _reference_keep(jtopk[0], mo.n_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert bool((~want_keep).any()) == drops
    close(out, jout)
    close(aux, jaux)


def test_capacity_is_per_call():
    """A decode step of 4 tokens routes at capacity 1 in both models (the
    reference's max(1, int(1.25 * 4 * 8 / E))), the 32768-token prefill
    at 8192 (granite) and 1280 (deepseek)."""
    for arch, prefill_cap in ((GRANITE, 8192), (DEEPSEEK, 1280)):
        cfg = dataclasses.replace(get_config(arch), d_model=16,
                                  dtype=torch.float32)
        gen = torch.Generator().manual_seed(0)
        p = {"router": torch.randn(16, cfg.moe.n_experts, generator=gen)}
        for n, want in ((4, 1), (32768, prefill_cap)):
            xs = torch.randn(n, 16, generator=gen)
            *_, keep, cap = L.moe_route(cfg, p, xs)
            assert cap == want
            assert keep.shape == (n * cfg.moe.top_k,)


def test_alltoall_is_the_identity_on_one_device():
    comm = Comm()
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert comm.alltoall(x, "model") is x
    assert comm.alltoall(x, None, split_axis=1) is x
    with pytest.raises(ValueError, match="split_axis"):
        comm.alltoall(x, ("data", "model"), split_axis=0, concat_axis=1)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def test_mla_attention_matches_jax(weights):
    """MLA's full-sequence attention (head dim 24 against v's 16, scaled
    by 1/sqrt(24)) on one layer's weights, at ragged positions."""
    jcfg, cfg = configs(DEEPSEEK)
    jp, params = weights[DEEPSEEK]
    x = np.random.default_rng(2).standard_normal(
        (2, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    jp0 = jax.tree.map(jnp.asarray, per_layer(jp, "dense_layers")[0])
    want = JL.mla_attention(jcomm(), jcfg, jp0["attn"], jnp.asarray(x),
                            jnp.asarray(pos))
    got = L.mla_attention(Comm(), cfg, params["dense_layers"][0]["attn"],
                          t(x), t(pos).long())
    close(got, want)


def test_mla_attention_reaches_kernel_4_at_its_head_dims(weights):
    """q and k at head dim nope + rope, v at v_dim, k contiguous, and
    sm_scale 1/sqrt(nope + rope)."""
    _, cfg = configs(DEEPSEEK)
    _, params = weights[DEEPSEEK]
    seen = []
    real = L.kops.attention

    def spy(q, k, v, **kw):
        seen.append((q.shape, k.shape, v.shape, k.is_contiguous(),
                     kw["sm_scale"], kw["causal"]))
        return real(q, k, v, **kw)

    with mock.patch.object(L.kops, "attention", spy):
        L.mla_attention(Comm(), cfg, params["layers"][0]["attn"],
                        torch.randn(1, 5, cfg.d_model),
                        torch.arange(5)[None])
    (qs, ks, vs, contiguous, scale, causal), = seen
    assert qs == ks == (1, 4, 5, 24) and vs == (1, 4, 5, 16)
    assert contiguous and causal and scale == 1 / np.sqrt(24)


def test_mla_decode_matches_jax(weights):
    """Seven mla_decode steps against a latent cache of 8 slots, from
    ragged positions per row (the last past the cache, written at its
    last slot): the output and both cache leaves every step."""
    jcfg, cfg = configs(DEEPSEEK)
    jp, params = weights[DEEPSEEK]
    B, S = 2, 8
    jp0 = jax.tree.map(jnp.asarray, per_layer(jp, "layers")[0]["attn"])
    p0 = params["layers"][0]["attn"]
    jcache = JL.init_mla_cache(jcfg, B, S)
    cache = L.init_mla_cache(cfg, B, S, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (v.shape, JDT[v.dtype]) for k, v in jcache.items()}
    rng = np.random.default_rng(3)
    for step in range(7):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([step, min(step + 3, 9)], np.int32)
        jy, jcache = JL.mla_decode(jcomm(), jcfg, jp0, jnp.asarray(x),
                                   jcache, jnp.asarray(pos))
        y, cache = L.mla_decode(Comm(), cfg, p0, t(x), cache, t(pos).long())
        close(y, jy, err_msg=str(step))
        for k in ("c_kv", "k_rope"):
            close(cache[k], jcache[k], err_msg=f"{step} {k}")


# ---------------------------------------------------------------------------
# the full-sequence entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [6, 17])
def test_forward_and_prefill_match_jax(weights, arch, seq):
    jcfg, cfg = configs(arch)
    jp, params = weights[arch]
    tokens = _tokens(cfg.vocab, 2, seq)
    jparams = jax.tree.map(jnp.asarray, jp)
    h, aux = T.forward(Comm(), cfg, params, t(tokens).long())
    jh, jaux = JT.forward(jcomm(), jcfg, jparams, jnp.asarray(tokens))
    close(h, jh)
    close(aux, jaux)
    assert float(aux) > 0
    logits = sstep.build_prefill(cfg)(params, {"tokens": t(tokens).long()})
    jlogits = JT.prefill(jcomm(), jcfg, jparams, jnp.asarray(tokens))
    assert logits.shape == (2, 1, cfg.vocab) and logits.grad_fn is None
    close(logits, jlogits)


def test_aux_sums_the_moe_layers_only(weights):
    """forward's aux is the sum over the MoE layers, in order; deepseek's
    dense layer adds nothing."""
    _, cfg = configs(DEEPSEEK)
    _, params = weights[DEEPSEEK]
    auxes = []
    real = L.moe

    def spy(*a):
        out = real(*a)
        auxes.append(out[1])
        return out

    with mock.patch.object(L, "moe", spy):
        _, aux = T.forward(Comm(), cfg, params,
                           torch.ones(1, 5, dtype=torch.long))
    assert len(auxes) == cfg.n_layers - cfg.moe.first_dense_layers == 2
    assert torch.equal(aux, torch.zeros(()) + auxes[0] + auxes[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(weights, arch):
    """train_loss (with the aux term, and deepseek's MTP head) and each
    gradient leaf against `jax.value_and_grad(train_loss)`."""
    jcfg, cfg = configs(arch)
    jp, params = weights[arch]
    tokens = _tokens(cfg.vocab, 2, 13, seed=4)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    jl, jg = jax.value_and_grad(lambda p: JT.train_loss(
        jcomm(), jcfg, p, jax.tree.map(jnp.asarray, batch)))(
        jax.tree.map(jnp.asarray, jp))
    loss, grads = tstep.loss_and_grads(Comm(), cfg, params,
                                       tstep.batch_to_device(batch, "cpu"))
    close(loss, jl)
    _assert_trees_close(params_to_jax(grads, cfg), jg)


def test_train_loss_adds_the_mtp_and_aux_terms(weights):
    """deepseek's loss is the token loss + 0.1 x the MTP head's + 0.01 x
    aux / n_layers: without "mtp" in the tree and with the aux weight at
    0 it is the plain cross-entropy."""
    _, cfg = configs(DEEPSEEK)
    _, params = weights[DEEPSEEK]
    tokens = t(_tokens(cfg.vocab, 1, 9)).long()
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    full = T.train_loss(Comm(), cfg, params, batch)
    h, aux = T.forward(Comm(), cfg, params, batch["tokens"])
    xent = L.sharded_xent(Comm(), cfg, L.lm_logits(
        Comm(), cfg, params["embed"], h), batch["targets"]).mean()
    no_mtp = T.train_loss(Comm(), cfg, {k: v for k, v in params.items()
                                        if k != "mtp"}, batch)
    close(no_mtp, (xent + 0.01 * aux / cfg.n_layers).detach().numpy(),
          rtol=1e-6, atol=0)
    assert float(full - no_mtp) > 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bit_for_bit(weights, arch):
    """params_from_jax then params_to_jax gives the reference's tree back
    exactly: "dense_layers" and "layers" stacked, "mtp" unstacked."""
    jp, params = weights[arch]
    _, cfg = configs(arch)
    got = jax.tree_util.tree_flatten_with_path(params_to_jax(params, cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=str(k))
    nd = cfg.moe.first_dense_layers
    assert len(params.get("dense_layers", [])) == nd
    assert len(params["layers"]) == cfg.n_layers - nd
    assert ("mtp" in params) == cfg.mtp


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_the_reference(arch):
    """The port's seeded tree has the reference's leaves (paths, shapes;
    dtypes in the full config's bf16 for deepseek) at the smoke size."""
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    for pdt, jpdt in ((torch.float32, jnp.float32),
                      (torch.bfloat16, jnp.bfloat16)):
        params = T.init_params(dataclasses.replace(cfg, param_dtype=pdt),
                               seed=0, device="cpu")
        want = jax.eval_shape(lambda: JT.init_params(
            jax.random.key(0), dataclasses.replace(jcfg, param_dtype=jpdt),
            1))
        got = params_to_jax(params, cfg)
        gp = jax.tree_util.tree_flatten_with_path(got)[0]
        wp = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [k for k, _ in gp] == [k for k, _ in wp]
        assert [a.shape for _, a in gp] == [w.shape for _, w in wp]
        assert sorted({str(w.dtype) for w in tree_flatten(params)[0]}) \
            == sorted({str(JDT[jnp.dtype(w.dtype)]) for _, w in wp})


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_init_params(arch):
    """test_models.py::test_param_count_sanity in the port (granite is in
    its list; deepseek here too): param_count() within 0.6-1.6 of the
    smoke init's size and equal to the reference's, for the full configs
    too."""
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    actual = sum(w.numel() for w in tree_flatten(params)[0])
    jshapes = jax.eval_shape(
        lambda: JT.init_params(jax.random.key(0), jcfg, 1))
    assert actual == sum(int(np.prod(s.shape))
                         for s in jax.tree.leaves(jshapes))
    assert 0.6 < cfg.param_count() / actual < 1.6
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.param_count(active_only=True) \
        == jcfg.param_count(active_only=True)
    full, jfull = get_config(arch), jax_config(arch)
    assert full.param_count() == jfull.param_count()
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab", "attn", "rope_theta", "mtp",
              "microbatches", "moment_dtype"):
        assert getattr(full, f) == getattr(jfull, f), f
    assert dataclasses.asdict(full.moe) == dataclasses.asdict(jfull.moe)
    assert (full.mla is None) == (jfull.mla is None)
    if full.mla is not None:
        assert dataclasses.asdict(full.mla) == dataclasses.asdict(jfull.mla)
    assert JDT[jnp.dtype(jfull.param_dtype)] == full.param_dtype
    if arch == GRANITE:
        assert full.param_count() == 3374294016
        assert full.param_dtype == torch.float32


def test_deepseek_serve_run_cut_is_its_dense_and_first_moe_layers():
    """SERVE_RUN cuts deepseek-v3 to 4 layers: its 3 dense MLA layers and
    its first MoE layer, 15,111,086,080 parameters by param_count (28.15
    GiB in bf16), and the reference's tree of that config adds the final
    norm, each MLA layer's two norms and the MTP head (686,251,008, 1.28
    GiB in bf16); the long decode's MLA caches at 32768 slots, batch 4 (on
    the meta device)."""
    run = deepseek_v3_671b.SERVE_RUN
    cfg = get_config(DEEPSEEK, n_layers=run["n_layers"])
    jcfg = jax_config(DEEPSEEK, n_layers=run["n_layers"])
    assert run["n_layers"] == cfg.moe.first_dense_layers + 1 == 4
    assert cfg.param_count() == jcfg.param_count() == 15111086080
    assert round(cfg.param_count() * 2 / 2**30, 2) == 28.15
    tree = jax.eval_shape(
        lambda: JT.init_params(jax.random.key(0), jcfg, 1))
    d = cfg.d_model
    mtp = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(tree["mtp"]))
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(tree))
    norms = cfg.n_layers * (cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank)
    assert n == cfg.param_count() + d + norms + mtp
    assert mtp == 686251008
    assert jax.tree.leaves(tree["layers"])[0].shape[0] == 1
    assert (run["prefill_len"], run["prefill_batch"]) == (32768, 1)
    assert (run["long_cache_len"], run["long_batch"]) == (32768, 4)
    cache = T.init_cache(cfg, 1, run["long_batch"], run["long_cache_len"],
                         device="meta")
    assert [len(cache["dense_layers"]), len(cache["layers"])] == [3, 1]
    for c in cache["dense_layers"] + cache["layers"]:
        assert tuple(c["c_kv"].shape) == (4, 32768, 512)
        assert tuple(c["k_rope"].shape) == (4, 32768, 64)


# ---------------------------------------------------------------------------
# the dense-cache decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_the_references_tree(arch):
    """GQA (granite) or MLA latent (deepseek) caches under "layers" and
    "dense_layers", shape, dtype and zeros, against the reference's
    stacked ones."""
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    jc = JT.init_cache(jcfg, 1, 3, 16)
    cache = T.init_cache(cfg, 1, 3, 16, device="cpu")
    assert sorted(cache) == sorted(jc)
    for group in jc:
        want = per_layer(jc, group)
        assert len(cache[group]) == len(want)
        for one, w in zip(cache[group], want):
            assert set(one) == set(w)
            for k in w:
                assert tuple(one[k].shape) == w[k].shape
                assert one[k].dtype == JDT[w[k].dtype]
                assert not one[k].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(weights, arch):
    """12 teacher-forced decode_steps against caches of 16 slots: the
    logits and every cache leaf against the reference's decode_step at
    each step.  (Not against forward: capacity differs between a step of
    B tokens and a prompt, so the reference's own
    test_decode_matches_forward leaves moe out.)"""
    jcfg, cfg = configs(arch)
    jp, params = weights[arch]
    B, S, steps = 3, 16, 12
    tokens = _tokens(cfg.vocab, B, steps)
    jparams = jax.tree.map(jnp.asarray, jp)
    jcache = JT.init_cache(jcfg, 1, B, S)
    jdecode = jstep.build_decode_step(jcfg, JAxisSpec(model=None), "xla")
    cache = T.init_cache(cfg, 1, B, S, device="cpu")
    decode = sstep.build_decode_step(cfg)
    for step in range(steps):
        batch = {"tokens": tokens[:, step:step + 1],
                 "positions": np.full((B,), step, np.int32)}
        jl, jcache = jdecode(jparams, jcache,
                             {k: jnp.asarray(v) for k, v in batch.items()})
        lg, cache = decode(params, cache,
                           {k: t(v).long() for k, v in batch.items()})
        close(lg, jl, err_msg=str(step))
        for group in jcache:
            for i, (one, w) in enumerate(zip(cache[group],
                                             per_layer(jcache, group))):
                for k in w:
                    close(one[k], w[k], err_msg=f"{step} {group} {i} {k}")


# ---------------------------------------------------------------------------
# int8 AdamW on deepseek's stacked dense and MoE layers
# ---------------------------------------------------------------------------

def _int8_codes_by_reference_leaf(params, st):
    """The port's int8 moment groups keyed by the reference's leaf path
    ("layers/attn/wq_a" for the group of every MoE layer's wq_a)."""
    names = [n for n, _ in ckpt._leaf_paths(params)]
    out = {}
    for group, mv in zip(opt.moment_groups(params, "int8"), st["mv"]):
        parts = names[group[0]].split("/")
        stacked = parts[0] in ("layers", "dense_layers")
        key = "/".join(parts[:1] + parts[2:]) if stacked else names[group[0]]
        out[key] = mv
    return out


def _reference_codes(jst):
    flat = jax.tree_util.tree_flatten_with_path(
        jst["mv"], is_leaf=lambda d: isinstance(d, dict) and "m" in d)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): mv
            for path, mv in flat}


def _deepseek_adamw(first_dense_layers, steps=3):
    """`steps` AdamW steps with int8 moments (deepseek's moment_dtype) on
    the deepseek smoke tree with `first_dense_layers` dense layers,
    through both packages on the same gradients."""
    jcfg, cfg = configs(DEEPSEEK)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, first_dense_layers=first_dense_layers))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, first_dense_layers=first_dense_layers))
    jp = _jax_weights(jcfg, 5)
    params = params_from_jax(jp, cfg)
    ocfg = opt.AdamWConfig(moment_dtype=get_config(DEEPSEEK).moment_dtype)
    jocfg = jopt.AdamWConfig(moment_dtype="int8")
    jparams = jax.tree.map(jnp.asarray, jp)
    st, jst = opt.init_state(params, ocfg), jopt.init_state(jparams, jocfg)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * .1)
                         .astype(np.float32), jp)
        params, st = opt.apply_updates(params, params_from_jax(g, cfg), st,
                                       ocfg)
        jparams, jst = jopt.apply_updates(
            jparams, jax.tree.map(jnp.asarray, g), jst, jocfg)
    return cfg, params, st, jparams, jst


@pytest.mark.parametrize("first_dense_layers", [1, 2])
def test_apply_updates_int8_matches_reference_on_deepseek(first_dense_layers):
    """Three AdamW steps with int8 moments on the deepseek smoke tree (and
    with two dense layers, where a block spans them): every int8 code and
    scale equal to the reference's, parameters within rtol 1e-6 (the C2
    test's rule), the dense layers' norms decayed as the reference's
    stacked 2-D leaves are."""
    assert get_config(DEEPSEEK).moment_dtype == "int8"
    cfg, params, st, jparams, jst = _deepseek_adamw(first_dense_layers)
    _assert_trees_close(params_to_jax(params, cfg), jparams, rtol=1e-6,
                        atol=0)
    got, want = _int8_codes_by_reference_leaf(params, st), \
        _reference_codes(jst)
    assert sorted(got) == sorted(want)
    assert "dense_layers/attn/wq_a" in want and "mtp/proj" in want
    for key in want:
        for mk in ("m", "v"):
            for part in ("q", "scale"):
                np.testing.assert_array_equal(
                    got[key][mk][part].numpy(),
                    np.asarray(want[key][mk][part]), err_msg=key)


def _old_decay_flags(params):
    """decay_flags before the moe family: only "layers" was stacked."""
    flags = []
    for key in sorted(params):
        extra = 1 if key == "layers" else 0
        flags += [l.dim() + extra >= 2 for l in tree_flatten(params[key])[0]]
    return flags


def _old_moment_groups(params, moment_dtype, local_global_period=None):
    """moment_groups before the moe family: only "layers" was blocked
    across its layers, every other leaf alone (no local/global split:
    `local_global_period` is taken and ignored)."""
    n = len(tree_flatten(params)[0])
    if moment_dtype != "int8":
        return [[i] for i in range(n)]
    groups, start = [], 0
    for key in sorted(params):
        sub = tree_flatten(params[key])[0]
        if key == "layers":
            per = len(tree_flatten(params[key][0])[0])
            groups += [[start + layer * per + j
                        for layer in range(len(params[key]))]
                       for j in range(per)]
        else:
            groups += [[start + j] for j in range(len(sub))]
        start += len(sub)
    return sorted(groups)


@pytest.mark.parametrize("rule", ["decay", "blocks"])
def test_the_layers_only_rule_would_differ_on_deepseek(monkeypatch, rule):
    """The rule before the moe family stacked "layers" only.  On
    deepseek's tree it leaves the dense layers' norms undecayed (the
    reference decays their stacked 2-D leaves), and with two dense layers
    it blocks their int8 moments layer by layer, where the reference's
    blocks span the stack: parameters (decay) or codes and scales
    (blocks) differ from the reference's."""
    nd = 1 if rule == "decay" else 2
    if rule == "decay":
        monkeypatch.setattr(opt, "decay_flags", _old_decay_flags)
    else:
        monkeypatch.setattr(opt, "moment_groups", _old_moment_groups)
    cfg, params, st, jparams, jst = _deepseek_adamw(nd)
    if rule == "decay":
        got = params_to_jax(params, cfg)["dense_layers"]
        assert not np.allclose(got["ln1"],
                               np.asarray(jparams["dense_layers"]["ln1"]),
                               rtol=1e-6, atol=0)
        return
    per_leaf = [n for n, _ in ckpt._leaf_paths(params)]
    want = _reference_codes(jst)
    differ = 0
    for key, mv in want.items():
        if not key.startswith("dense_layers/"):
            continue
        idx = [i for i, n in enumerate(per_leaf)
               if n.split("/")[0] == "dense_layers"
               and "/".join(n.split("/")[2:]) == key.split("/", 1)[1]]
        scales = np.concatenate([st["mv"][i]["m"]["scale"].numpy().ravel()
                                 for i in idx])
        ref_scales = np.asarray(mv["m"]["scale"]).ravel()
        differ += scales.shape != ref_scales.shape \
            or not np.array_equal(scales, ref_scales)
    assert differ > 0


# ---------------------------------------------------------------------------
# the load-balance aux, the launcher, the path without jax
# ---------------------------------------------------------------------------

def test_moe_router_load_balance_aux():
    """tests/test_models.py::test_moe_router_load_balance_aux in the port:
    on granite's smoke weights, all-ones tokens give aux per layer in
    (0.2, 5): E x sum(mean gate x mean picks) ~ 1 for a balanced
    router."""
    cfg = smoke_config(GRANITE)
    params = T.init_params(cfg, seed=0, device="cpu")
    _, aux = T.forward(Comm(), cfg, params, torch.ones(2, 16,
                                                       dtype=torch.long))
    assert 0.2 < float(aux) / cfg.n_layers < 5.0


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_smoke_on_cpu(arch, capsys):
    """The launcher routes the moe family (not paged) through the
    dense-cache decode loop: (4, 16) token ids within the vocabulary; a
    --cache-len shorter than the positions it decodes is refused."""
    gen = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert gen.shape == (4, 16) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < smoke_config(arch).vocab)).all()
    assert "(dense loop, cpu) generated (4, 16)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--cache-len", "16"])


MOE_BLOCKED = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None          # any import of them now fails
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.parallel.comm import Comm
    from repro_torch.serve import step
    for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
        cfg = smoke_config(arch)
        gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
        assert gen.shape == (4, 16)
        params = transformer.init_params(cfg, seed=0, device="cpu")
        tokens = torch.ones(2, 19, dtype=torch.long)
        logits = step.build_prefill(cfg)(params, {"tokens": tokens})
        assert logits.shape == (2, 1, cfg.vocab)
        assert torch.isfinite(logits).all()
        loss = transformer.train_loss(Comm(), cfg, params, {
            "tokens": tokens, "targets": tokens})
        assert torch.isfinite(loss)
    print("MOE-ALONE-OK")
""")


def test_moe_family_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", MOE_BLOCKED], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "MOE-ALONE-OK" in r.stdout
