"""The rest of the dense family in the port — gemma2-9b (local/global
layer pairs, softcaps, the sqrt(d) embedding scale), h2o-danube-3-4b (a
4096-token window on every layer) and internlm2-20b (bf16 weights) — on
the CPU against the JAX package, on the same weights (`params_from_jax`)
and numpy inputs, in f32 at rtol 1e-4, atol 1e-5: forward, prefill,
train_loss with every gradient leaf, the decode caches and teacher-forced
decode steps whose local rings wrap, the paged prefill and decode, the
parameter round trip; decode against forward in bf16; the embedding
scale's rounding; `init_params`' leaf-by-leaf cast; the launcher's engine
sizing; the path without jax.

The JAX functions run outside shard_map through a `Comm` whose model axis
is None (size 1), the port's through its one-device `Comm`."""
import dataclasses
import hashlib
import math
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
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.parallel.comm import AxisSpec as JAxisSpec
from repro.parallel.comm import Comm as JComm
from repro.serve import engine as jengine
from repro.serve import step as jstep
from repro.train import optimizer as jopt
from repro_torch.ckpt.manager import _leaf_paths as ckpt_leaf_paths
from repro_torch.configs import gemma2_9b, get_config, smoke_config
from repro_torch.core.heap import tree_flatten, tree_unflatten
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.parallel.comm import Comm
from repro_torch.serve import engine as pengine
from repro_torch.serve import step as sstep
from repro_torch.train import optimizer as opt
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["gemma2-9b", "h2o-danube-3-4b", "internlm2-20b"]
TOL = dict(rtol=1e-4, atol=1e-5)
# decode caches of S slots over more steps than the smoke window (16):
# the windowed layers' caches are rings of 16 slots that wrap
S_LONG, STEPS_LONG = 24, 22


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
    """The reference's smoke weights as numpy, the norms moved off zero
    so that each term is exercised."""
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(seed), jcfg,
                                                 1))
    rng = np.random.RandomState(seed)
    stacks = (list(jp["pairs"].values()) if "pairs" in jp
              else [jp["layers"]])
    for block in stacks:
        for k in ("ln1", "ln2"):
            block[k] = (rng.randn(*block[k].shape) * .1).astype(np.float32)
    jp["final_norm"] = (rng.randn(*jp["final_norm"].shape) * .1).astype(
        np.float32)
    return jp


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


def per_layer(cfg, tree):
    """The reference's stacked per-layer tree (caches or pools: "layers",
    or gemma2's "pairs_local"/"pairs_global") as one leaf dict per layer
    in the port's order."""
    if cfg.local_global_period is None:
        stacks = [(tree["layers"], i) for i in range(cfg.n_layers)]
    else:
        stacks = [(tree["pairs_local" if i % 2 == 0 else "pairs_global"],
                   i // 2) for i in range(cfg.n_layers)]
    return [{k: v[j] for k, v in s.items()} for s, j in stacks]


# ---------------------------------------------------------------------------
# the layer pattern and the full-sequence entries
# ---------------------------------------------------------------------------

def test_layer_windows_follow_the_reference():
    """gemma2's even layers are local (window 4096), its odd ones global;
    danube windows every layer at 4096, internlm2 none."""
    g, d, i = (get_config(a) for a in ARCHS)
    assert [T._is_local(g, n) for n in range(4)] == [True, False] * 2
    assert [L.layer_window(g, T._is_local(g, n)) for n in range(4)] \
        == [4096, None, 4096, None]
    assert [L.layer_window(d, T._is_local(d, n)) for n in range(2)] \
        == [4096, 4096]
    assert [L.layer_window(i, T._is_local(i, n)) for n in range(2)] \
        == [None, None]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [8, 24])           # inside; past window 16
def test_forward_and_prefill_match_jax(weights, arch, seq):
    jcfg, cfg = configs(arch)
    jp, params = weights[arch]
    tokens = _tokens(cfg.vocab, 2, seq)
    jparams = jax.tree.map(jnp.asarray, jp)
    h, aux = T.forward(Comm(), cfg, params, t(tokens).long())
    jh, _ = JT.forward(jcomm(), jcfg, jparams, jnp.asarray(tokens))
    close(h, jh)
    assert float(aux) == 0.0
    logits = sstep.build_prefill(cfg)(params, {"tokens": t(tokens).long()})
    jlogits = JT.prefill(jcomm(), jcfg, jparams, jnp.asarray(tokens))
    assert logits.shape == (2, 1, cfg.vocab) and logits.grad_fn is None
    close(logits, jlogits)


def test_local_layers_attend_through_the_local_window(weights):
    """gemma2's forward calls attention with window 16 on layer 0 and none
    on layer 1, exactly as the reference's pair does."""
    _, cfg = configs("gemma2-9b")
    _, params = weights["gemma2-9b"]
    seen = []
    real = L.kops.attention

    def spy(q, k, v, **kw):
        seen.append((kw["window"], kw["softcap"]))
        return real(q, k, v, **kw)

    with mock.patch.object(L.kops, "attention", spy):
        T.forward(Comm(), cfg, params, torch.ones(1, 4, dtype=torch.long))
    assert seen == [(16, 50.0), (None, 50.0)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(weights, arch):
    """train_loss (gemma2: final_softcap inside sharded_xent) and each
    gradient leaf against `jax.value_and_grad(train_loss)`, over a
    sequence past the smoke window."""
    jcfg, cfg = configs(arch)
    jp, params = weights[arch]
    tokens = _tokens(cfg.vocab, 2, 21, seed=4)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    jl, jg = jax.value_and_grad(lambda p: JT.train_loss(
        jcomm(), jcfg, p, jax.tree.map(jnp.asarray, batch)))(
        jax.tree.map(jnp.asarray, jp))
    loss, grads = tstep.loss_and_grads(Comm(), cfg, params,
                                       tstep.batch_to_device(batch, "cpu"))
    close(loss, jl)
    got = jax.tree_util.tree_flatten_with_path(params_to_jax(grads, cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   err_msg=str(k), **TOL)


def test_gemma2_adamw_with_bf16_moments_matches_jax(weights):
    """gemma2's optimizer (bf16 moments) on the pairs' tree: three AdamW
    steps against the reference's, parameters at rtol 1e-6 (test_torch_
    train's rule: two pow implementations of `1 - b**t`) and the moments
    equal."""
    jp, params = weights["gemma2-9b"]
    _, cfg = configs("gemma2-9b")
    ocfg = opt.AdamWConfig(moment_dtype=get_config("gemma2-9b").moment_dtype)
    jocfg = jopt.AdamWConfig(moment_dtype="bf16")
    jparams = jax.tree.map(jnp.asarray, jp)
    st, jst = opt.init_state(params, ocfg), jopt.init_state(jparams, jocfg)
    rng = np.random.default_rng(1)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), jp)
        params, st = opt.apply_updates(params, params_from_jax(g, cfg), st,
                                       ocfg)
        jparams, jst = jopt.apply_updates(
            jparams, jax.tree.map(jnp.asarray, g), jst, jocfg)
    for a, b in zip(jax.tree.leaves(params_to_jax(params, cfg)),
                    jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=0)
    _, treedef = tree_flatten(params)
    for key in ("m", "v"):
        got = params_to_jax(tree_unflatten(
            treedef, [mv[key] for mv in st["mv"]]), cfg)
        want = jax.tree.map(lambda d: d[key], jst["mv"],
                            is_leaf=lambda d: isinstance(d, dict)
                            and key in d)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# fault C3: int8 moments of the local/global tree, blocked per stack
# ---------------------------------------------------------------------------

def _gemma2_int8_adamw(weights, steps=3, local_global_period="config"):
    """`steps` AdamW steps with int8 moments on gemma2's smoke tree
    through both packages on the same gradients; the port's optimizer is
    given the config's local_global_period (or the one passed)."""
    jp, params = weights["gemma2-9b"]
    _, cfg = configs("gemma2-9b")
    period = (cfg.local_global_period if local_global_period == "config"
              else local_global_period)
    ocfg = opt.AdamWConfig(moment_dtype="int8")
    jocfg = jopt.AdamWConfig(moment_dtype="int8")
    jparams = jax.tree.map(jnp.asarray, jp)
    st = opt.init_state(params, ocfg, period)
    jst = jopt.init_state(jparams, jocfg)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * .1)
                         .astype(np.float32), jp)
        params, st = opt.apply_updates(params, params_from_jax(g, cfg), st,
                                       ocfg, period)
        jparams, jst = jopt.apply_updates(
            jparams, jax.tree.map(jnp.asarray, g), jst, jocfg)
    return cfg, params, st, jparams, jst


def _reference_int8_codes(jst):
    """The reference's int8 moments keyed by leaf path."""
    flat = jax.tree_util.tree_flatten_with_path(
        jst["mv"], is_leaf=lambda d: isinstance(d, dict) and "m" in d)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): mv
            for path, mv in flat}


def _port_int8_codes(params, st, period):
    """The port's int8 moment groups keyed by the reference's leaf path: a
    group of "layers" leaves is pairs/local/<leaf> when it holds the even
    (local) layers, pairs/global/<leaf> the odd ones."""
    names = [n for n, _ in ckpt_leaf_paths(params)]
    out = {}
    for group, mv in zip(opt.moment_groups(params, "int8", period),
                         st["mv"]):
        parts = names[group[0]].split("/")
        if parts[0] == "layers":
            stack = "local" if int(parts[1]) % 2 == 0 else "global"
            key = "/".join(["pairs", stack] + parts[2:])
        else:
            key = names[group[0]]
        out[key] = mv
    return out


def test_apply_updates_int8_matches_reference_on_the_pairs(weights):
    """Fault C3: three AdamW steps with int8 moments on gemma2's smoke
    tree, the port's even layers blocked as the reference's pairs/local
    stack and its odd ones as pairs/global: every int8 code and scale
    equal to the reference's, parameters within rtol 1e-6 (the C2 test's
    rule)."""
    cfg, params, st, jparams, jst = _gemma2_int8_adamw(weights)
    for a, b in zip(jax.tree.leaves(params_to_jax(params, cfg)),
                    jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=0)
    got = _port_int8_codes(params, st, cfg.local_global_period)
    want = _reference_int8_codes(jst)
    assert sorted(got) == sorted(want)
    assert "pairs/local/ln1" in want and "pairs/global/attn/wq" in want
    for key in want:
        for mk in ("m", "v"):
            for part in ("q", "scale"):
                np.testing.assert_array_equal(
                    got[key][mk][part].numpy(),
                    np.asarray(want[key][mk][part]), err_msg=key)


def test_the_interleaved_rule_would_differ_on_the_pairs(weights):
    """The rule before C3's repair blocked gemma2's interleaved "layers"
    as one stack: its d-64 norms then share one 128-element block across
    local layer 0 and global layer 1, where the reference blocks each
    stack apart, so the scales differ from the reference's."""
    _, cfg = configs("gemma2-9b")
    _, params, st, _, jst = _gemma2_int8_adamw(weights,
                                               local_global_period=None)
    groups = opt.moment_groups(params, "int8")
    assert len(groups) < len(opt.moment_groups(params, "int8",
                                               cfg.local_global_period))
    names = [n for n, _ in ckpt_leaf_paths(params)]
    ln1 = next(mv for g, mv in zip(groups, st["mv"])
               if names[g[0]] == "layers/0/ln1")
    want = _reference_int8_codes(jst)
    ref = np.concatenate([np.asarray(want[f"pairs/{s}/ln1"]["m"]["scale"])
                          .ravel() for s in ("local", "global")])
    got = ln1["m"]["scale"].numpy().ravel()
    assert got.shape != ref.shape or not np.array_equal(got, ref)


def test_train_step_threads_the_local_global_period(weights):
    """build_train_step hands cfg.local_global_period to apply_updates:
    its int8 step runs on a state made with the period, and refuses one
    made without it (other groups) rather than misreading it."""
    _, params = weights["gemma2-9b"]
    _, cfg = configs("gemma2-9b")
    adamw = opt.AdamWConfig(moment_dtype="int8")
    step = tstep.build_train_step(cfg, adamw=adamw)
    tokens = _tokens(cfg.vocab, 2, 9, seed=2)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    loss, new, st = step(params, opt.init_state(
        params, adamw, cfg.local_global_period), batch)
    assert np.isfinite(float(loss)) and int(st["step"]) == 1
    with pytest.raises(ValueError, match="moment groups"):
        step(params, opt.init_state(params, adamw), batch)


# ---------------------------------------------------------------------------
# the dense-cache decode
# ---------------------------------------------------------------------------

JDT = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float32): torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_the_references_tree(arch):
    """Each layer's cache against the reference's stacked one (gemma2:
    pairs_local rings of min(S, local_window) slots, pairs_global of S),
    shape, dtype and zeros, at S past the window and inside it."""
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    for S in (S_LONG, 8):
        jc = JT.init_cache(jcfg, 1, 3, S)
        cache = T.init_cache(cfg, 1, 3, S, device="cpu")
        assert list(cache) == ["layers"]
        want = per_layer(cfg, jc)
        assert len(cache["layers"]) == len(want) == cfg.n_layers
        for i, (one, w) in enumerate(zip(cache["layers"], want)):
            assert set(one) == set(w) == {"k", "v"}
            for k in "kv":
                assert tuple(one[k].shape) == w[k].shape, (S, i, k)
                assert one[k].dtype == JDT[w[k].dtype]
                assert not one[k].any()
        slots = [c["k"].shape[1] for c in cache["layers"]]
        window = {"gemma2-9b": [16, S], "h2o-danube-3-4b": [16, 16],
                  "internlm2-20b": [S, S]}[arch]
        assert slots == [min(S, w) for w in window]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(weights, arch):
    """Teacher-forced decode_step, 22 steps against caches of 24 slots:
    the logits and every cache leaf against the reference's
    build_decode_step at each step; the windowed layers' rings of 16
    slots wrap after step 16."""
    jcfg, cfg = configs(arch)
    jp, params = weights[arch]
    B = 2
    tokens = _tokens(cfg.vocab, B, STEPS_LONG)
    jparams = jax.tree.map(jnp.asarray, jp)
    jcache = JT.init_cache(jcfg, 1, B, S_LONG)
    jdecode = jstep.build_decode_step(jcfg, JAxisSpec(model=None), "xla")
    cache = T.init_cache(cfg, 1, B, S_LONG, device="cpu")
    decode = sstep.build_decode_step(cfg)
    for step in range(STEPS_LONG):
        batch = {"tokens": tokens[:, step:step + 1],
                 "positions": np.full((B,), step, np.int32)}
        jl, jcache = jdecode(jparams, jcache,
                             {k: jnp.asarray(v) for k, v in batch.items()})
        lg, cache = decode(params, cache,
                           {k: t(v).long() for k, v in batch.items()})
        close(lg, jl, err_msg=str(step))
        for i, (one, w) in enumerate(zip(cache["layers"],
                                         per_layer(cfg, jcache))):
            for k in "kv":
                close(one[k], w[k], err_msg=f"{step} {i} {k}")
    if arch != "internlm2-20b":
        assert cache["layers"][0]["k"].shape[1] == 16 < STEPS_LONG


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_past_the_window(arch):
    """In f32, 22 teacher-forced decode steps (rings of 16 slots that
    wrap) give the full forward's logits at every step: the ring's slots
    hold exactly the keys the forward's window mask keeps."""
    cfg = smoke_config(arch, dtype=torch.float32)
    params = T.init_params(cfg, seed=1, device="cpu")
    B = 2
    tokens = t(_tokens(cfg.vocab, B, STEPS_LONG, seed=0)).long()
    comm = Comm()
    h, _ = T.forward(comm, cfg, params, tokens)
    full = L.lm_logits(comm, cfg, params["embed"], h)
    cache = T.init_cache(cfg, 1, B, S_LONG, device="cpu")
    for step in range(STEPS_LONG):
        lg, cache = T.decode_step(comm, cfg, params, cache,
                                  tokens[:, step:step + 1],
                                  torch.full((B,), step))
        close(lg[:, 0], full[:, step].numpy(), err_msg=str(step))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_bf16(arch):
    """tests/test_models.py::test_decode_matches_forward[gemma2-9b] (and
    danube, internlm2) in the port: teacher-forced decode logits equal the
    full forward's at every one of 12 steps, caches of 16 slots, bf16 at
    that test's 0.12."""
    cfg = smoke_config(arch)
    params = T.init_params(cfg, seed=1, device="cpu")
    B, steps = 2, 12
    tokens = t(_tokens(cfg.vocab, B, steps, seed=0)).long()
    comm = Comm()
    h, _ = T.forward(comm, cfg, params, tokens)
    full = L.lm_logits(comm, cfg, params["embed"], h)
    cache = T.init_cache(cfg, 1, B, 16, device="cpu")
    errs = []
    for step in range(steps):
        lg, cache = T.decode_step(comm, cfg, params, cache,
                                  tokens[:, step:step + 1],
                                  torch.full((B,), step))
        errs.append(float((lg[:, 0].float() - full[:, step].float())
                          .abs().max()))
    assert max(errs) < 0.12, errs


# ---------------------------------------------------------------------------
# the paged path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_match_jax(weights, arch):
    """prefill_paged over a 24-token bucket (past the window of 16) into
    pages 3, 1, 4 and 6 of 8 tokens, then 5 decode_step_paged steps: the
    logits and every layer's pool against the reference's (gemma2's
    pairs_local / pairs_global pools) at each step."""
    jcfg, cfg = configs(arch)
    jp, params = weights[arch]
    page, n_pages, bucket = 8, 8, 24
    jparams = jax.tree.map(jnp.asarray, jp)
    jpool = JT.init_kv_pool(jcfg, 1, n_pages, page)
    pool = T.init_kv_pool(cfg, 1, n_pages, page, "cpu")
    table = np.array([[3, 1, 4, 6]], np.int32)
    tokens = _tokens(cfg.vocab, 1, bucket + 5, seed=6)
    positions = np.arange(bucket, dtype=np.int32)[None]

    def same_pools():
        for i, w in enumerate(per_layer(cfg, jpool)):
            for k in "kv":
                close(pool[k][i], w[k], err_msg=f"layer {i} {k}")

    lg, pool = T.prefill_paged(Comm(), cfg, params, pool, t(table).long(),
                               t(tokens[:, :bucket]).long(),
                               t(positions).long(), page_size=page)
    jl, jpool = JT.prefill_paged(jcomm(), jcfg, jparams, jpool,
                                 jnp.asarray(table),
                                 jnp.asarray(tokens[:, :bucket]),
                                 jnp.asarray(positions), page_size=page)
    close(lg, jl)
    same_pools()
    for pos in range(bucket, bucket + 5):
        tok = tokens[:, pos:pos + 1]
        lg, pool = T.decode_step_paged(
            Comm(), cfg, params, pool, t(table).long(), t(tok).long(),
            torch.tensor([pos]), page_size=page)
        jl, jpool = JT.decode_step_paged(
            jcomm(), jcfg, jparams, jpool, jnp.asarray(table),
            jnp.asarray(tok), jnp.asarray([pos], np.int32), page_size=page)
        close(lg, jl, err_msg=str(pos))
        same_pools()


def test_kv_pool_keeps_one_shape_for_every_layer():
    """The paged pool windows by mask only: gemma2's local layers keep
    pools as long as the global ones, as the reference's pairs do."""
    cfg, jcfg = smoke_config("gemma2-9b"), jax_smoke("gemma2-9b")
    pool = T.init_kv_pool(cfg, 1, 5, 8, "cpu")
    jpool = jax.eval_shape(lambda: JT.init_kv_pool(jcfg, 1, 5, 8))
    for k in "kv":
        assert tuple(pool[k].shape) == (cfg.n_layers,) \
            + jpool["pairs_local"][k].shape[1:] \
            == (cfg.n_layers,) + jpool["pairs_global"][k].shape[1:]


# ---------------------------------------------------------------------------
# parameters: the pairs' layout, the embedding scale, the leaf-by-leaf cast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bit_for_bit(weights, arch):
    """params_from_jax then params_to_jax gives the reference's tree back
    exactly (gemma2: pair i's local and global blocks are the port's
    layers 2i and 2i + 1)."""
    jp, params = weights[arch]
    _, cfg = configs(arch)
    got = jax.tree_util.tree_flatten_with_path(params_to_jax(params, cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=str(k))
    if cfg.local_global_period:
        np.testing.assert_array_equal(
            params["layers"][1]["attn"]["wq"].numpy(),
            jp["pairs"]["global"]["attn"]["wq"][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_init_params(arch):
    """test_models.py::test_param_count_sanity in the port: param_count()
    within 0.6-1.6 of the smoke init's size and equal to the reference's,
    for the full configs too, whose reference trees hold (gemma2-9b)
    10,158,908,928 parameters, param_count() and the final norm's d, and
    (internlm2-20b) 39.7 GB of bf16 weights."""
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    actual = sum(w.numel() for w in tree_flatten(params)[0])
    jshapes = jax.eval_shape(
        lambda: JT.init_params(jax.random.key(0), jcfg, 1))
    assert actual == sum(int(np.prod(s.shape))
                         for s in jax.tree.leaves(jshapes))
    assert 0.6 < cfg.param_count() / actual < 1.6
    assert cfg.param_count() == jcfg.param_count()
    full, jfull = get_config(arch), jax_config(arch)
    assert full.param_count() == jfull.param_count()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "window", "local_global_period",
              "local_window", "softcap", "final_softcap", "rope_theta",
              "qkv_bias", "tie_embeddings", "microbatches", "moment_dtype"):
        assert getattr(full, f) == getattr(jfull, f), f
    assert JDT[jnp.dtype(jfull.param_dtype)] == full.param_dtype
    tree = jax.eval_shape(
        lambda: JT.init_params(jax.random.key(0), jfull, 1))
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(tree))
    assert n == full.param_count() + full.d_model
    if arch == "gemma2-9b":
        assert n == 10158908928
    if arch == "internlm2-20b":
        assert full.param_dtype == torch.bfloat16
        assert round(n * 2 / 1e9, 1) == 39.7


def test_serve_run_cuts_follow_the_reference_shapes():
    """gemma2's SERVE_RUN: `prefill_32k` at batch 1 and `decode_32k`'s
    32768 slots at batch 2, whose caches are 21 rings of 4096 slots and
    21 global caches of 11.3 GB (counted on the meta device)."""
    run = gemma2_9b.SERVE_RUN
    assert (run["prefill_len"], run["prefill_batch"]) == (32768, 1)
    assert (run["long_cache_len"], run["long_batch"]) == (32768, 2)
    cache = T.init_cache(get_config("gemma2-9b"), 1, run["long_batch"],
                         run["long_cache_len"], device="meta")
    slots = [c["k"].shape[1] for c in cache["layers"]]
    assert slots == [4096, 32768] * 21
    glob = sum(c[k].numel() * 2 for c in cache["layers"][1::2] for k in "kv")
    assert glob == 21 * 2 * 32768 * 8 * 256 * 2 * 2


def test_embedding_scale_rounds_like_the_reference():
    """gemma2 multiplies its embedding by sqrt(d) rounded to the compute
    dtype: in bf16 that is 59.75 for d 3584, not 59.866.  The port's
    bf16 product equals the reference's bit for bit, and differs from a
    product by the unrounded scalar."""
    kw = dict(d_model=3584, n_heads=14, head_dim=16)
    jcfg, cfg = jax_smoke("gemma2-9b", **kw), smoke_config("gemma2-9b", **kw)
    assert cfg.dtype == torch.bfloat16
    assert torch.tensor(math.sqrt(3584), dtype=torch.bfloat16).item() \
        == 59.75
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg, 1))
    params = params_from_jax(jp, cfg)
    tokens = _tokens(cfg.vocab, 2, 9)
    got = T._embed_scaled(Comm(), cfg, params, t(tokens).long())
    want = JT._embed_scaled(jcomm(), jcfg, jp, jnp.asarray(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    unrounded = L.embed(Comm(), cfg, params["embed"], t(tokens).long()) \
        * math.sqrt(3584)
    assert (unrounded.float() != got.float()).any()
    plain = smoke_config("internlm2-20b")
    assert torch.equal(
        T._embed_scaled(Comm(), plain, {"embed": params["embed"]},
                        t(tokens).long()),
        L.embed(Comm(), plain, params["embed"], t(tokens).long()))


def _stacked_dims(tree):
    """Each leaf's dims in the reference's layout, in tree_flatten order:
    a leaf of a stacked list ("layers", "dense_layers") has one more."""
    return [l.dim() + (1 if k in ("layers", "dense_layers") else 0)
            for k in sorted(tree) for l in tree_flatten(tree[k])[0]]


def _cast_at_the_end(cfg, seed):
    """The f32 tree of `cfg` cast to its param_dtype afterwards (the rule
    `repro` applies to its whole stacked tree: leaves of two or more
    dims there)."""
    f32 = T.init_params(dataclasses.replace(cfg, param_dtype=torch.float32),
                        seed=seed, device="cpu")
    leaves, treedef = tree_flatten(f32)
    return tree_unflatten(treedef, [
        w.to(cfg.param_dtype) if nd >= 2 else w
        for w, nd in zip(leaves, _stacked_dims(f32))])


@pytest.mark.parametrize("arch", ["internlm2-20b", "gemma2-9b"])
def test_bf16_init_equals_f32_then_cast(arch):
    """bf16 everywhere the reference's cast reaches: weights, and the
    vectors of stacked layers (its layer norms); f32 elsewhere."""
    cfg = smoke_config(arch, param_dtype=torch.bfloat16)
    tree = T.init_params(cfg, seed=5, device="cpu")
    got, _ = tree_flatten(tree)
    want, _ = tree_flatten(_cast_at_the_end(cfg, 5))
    assert len(got) == len(want)
    for a, b, nd in zip(got, want, _stacked_dims(tree)):
        assert a.dtype == b.dtype == (torch.bfloat16 if nd >= 2
                                      else torch.float32)
        assert torch.equal(a, b)
    assert tree["layers"][0]["ln1"].dtype == torch.bfloat16
    assert tree["final_norm"].dtype == torch.float32


def test_init_params_casts_each_leaf_before_the_next_is_made():
    """Every weight of the bf16 tree is already bf16 when the next leaf is
    drawn: the draws are recorded as they are made, each is bf16 the
    moment it is handed back, and the tree holds exactly those tensors
    (nothing is cast afterwards), so no f32 copy of the tree exists."""
    cfg = smoke_config("internlm2-20b", param_dtype=torch.bfloat16)
    made = []
    real = L._normal

    def record(*a, **kw):
        assert all(w.dtype == torch.bfloat16 for w in made)
        w = real(*a, **kw)
        made.append(w)
        return w

    with mock.patch.object(L, "_normal", record):
        params = T.init_params(cfg, seed=0, device="cpu")
    assert all(w.dtype == torch.bfloat16 for w in made)
    weights_2d = [w for w in tree_flatten(params)[0] if w.dim() >= 2]
    assert len(weights_2d) == len(made)
    assert {id(w) for w in weights_2d} == {id(w) for w in made}


# sha256 (first 16 hex digits) of each seed-0 smoke tree's leaves, shapes
# and dtypes in tree_flatten order, as `init_params` made them when it
# cast the whole f32 tree at its end (the bf16 trees with their stacked
# layers' vectors in bf16, the reference's cast of its stacked tree)
SEEDED = {("qwen2-0.5b", "f32"): "fcf6de3419279467",
          ("qwen2-0.5b", "bf16"): "bfa26118a60e3eff",
          ("mamba2-2.7b", "f32"): "c0453b817c1e2b54",
          ("mamba2-2.7b", "bf16"): "457cd6768be0165e",
          ("zamba2-1.2b", "f32"): "f9d952bfb2a393ee",
          ("zamba2-1.2b", "bf16"): "1dbf4ff7fc15eac6"}


@pytest.mark.parametrize("arch,dtype", list(SEEDED))
def test_earlier_archs_seeded_weights_are_unchanged(arch, dtype):
    cfg = smoke_config(arch)
    if dtype == "bf16":
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    h = hashlib.sha256()
    for leaf in tree_flatten(T.init_params(cfg, seed=0, device="cpu"))[0]:
        h.update(str((tuple(leaf.shape), str(leaf.dtype))).encode())
        h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest()[:16] == SEEDED[arch, dtype]


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def _engines(module):
    """A patch of `module.ServeEngine` that records each engine built."""
    built = []

    class Recording(module.ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    return built, mock.patch.object(module, "ServeEngine", Recording)


@pytest.mark.parametrize("extra", [[], ["--cache-len", "16"]])
def test_launcher_sizes_the_engine_as_the_reference(extra):
    """repro/launch/serve.py:163: max_seq = max(--cache-len, prompt +
    tokens), so the defaults give 128 (not 48) and 8 pages a slot; a
    short --cache-len leaves prompt + tokens."""
    argv = ["--arch", "qwen2-0.5b", "--smoke"] + extra
    port, p1 = _engines(pengine)
    ref, p2 = _engines(jengine)
    with p1, p2:
        gen = launch_serve.main(argv + ["--device", "cpu"])
        jgen = jserve.main(argv)
    (eng,), (jeng,) = port, ref
    assert gen.shape == np.asarray(jgen).shape == (4, 16)
    assert eng.max_seq == jeng.max_seq == (48 if extra else 128)
    assert eng.kv.max_pages == jeng.kv.max_pages
    assert eng.kv.pool.num_pages == jeng.kv.pool.num_pages
    assert eng.prompt_bucket == jeng.prompt_bucket == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_smoke_on_cpu(arch, capsys):
    """Each architecture through the launcher's paged engine with the
    reference's defaults: (4, 16) token ids within the vocabulary."""
    gen = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert gen.shape == (4, 16) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < smoke_config(arch).vocab)).all()
    assert "(paged, cpu) generated (4, 16)" in capsys.readouterr().out


GEMMA_BLOCKED = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None          # any import of them now fails
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serve import step
    for arch in ("gemma2-9b", "internlm2-20b"):
        cfg = smoke_config(arch)
        gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
        assert gen.shape == (4, 16)
        params = transformer.init_params(cfg, seed=0, device="cpu")
        logits = step.build_prefill(cfg)(params, {"tokens": torch.ones(
            2, 19, dtype=torch.long)})
        assert logits.shape == (2, 1, cfg.vocab)
        assert torch.isfinite(logits).all()
    print("DENSE-ALONE-OK")
""")


def test_dense_family_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", GEMMA_BLOCKED], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "DENSE-ALONE-OK" in r.stdout
