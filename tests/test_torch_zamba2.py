"""The port's hybrid family (zamba2) and the dense-cache attention decode
of the dense family on the CPU against the JAX package, on the same
weights (`params_from_jax`) and numpy inputs, in f32 at rtol 1e-4, atol
1e-5: the hybrid forward, prefill, caches and decode steps, the dense
`init_cache`/`decode_step`, `attention_decode` and `_cache_attend` on
plain, windowed and ring caches, decode against forward in bf16, the
launcher's decode loop, and the zamba2 path without jax.

The JAX functions run outside shard_map through a `Comm` whose model
axis is None (size 1), the port's through its one-device `Comm`."""
import argparse
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
from repro.launch import serve as jserve
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.parallel.comm import AxisSpec as JAxisSpec
from repro.parallel.comm import Comm as JComm
from repro.serve import step as jstep
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs import zamba2_1_2b
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.parallel.comm import Comm
from repro_torch.serve import step as sstep
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
ARCH = "zamba2-1.2b"
DENSE = "qwen2-0.5b"
TOL = dict(rtol=1e-4, atol=1e-5)
# (arch, window): the ring cases give the dense family a sliding window
# narrower than the cache, so that init_cache makes a ring of that width
CASES = {"zamba2": (ARCH, None), "qwen2": (DENSE, None),
         "qwen2_ring": (DENSE, 5)}


def jcomm():
    return JComm(JAxisSpec(model=None), "xla")


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, **kw):
    np.testing.assert_allclose(a.detach().float().numpy(),
                               np.asarray(b, np.float32), **{**TOL, **kw})


def configs(arch, window=None):
    """(reference config, port config) of `arch`'s smoke size in f32."""
    jcfg = jax_smoke(arch, dtype=jnp.float32, window=window)
    cfg = smoke_config(arch, dtype=torch.float32, window=window)
    return jcfg, cfg


def _jax_weights(jcfg, seed):
    """The reference's smoke weights as numpy, with every zero-initialised
    vector (conv_b, dt_bias, norm_w, the norms, qkv biases) moved off zero
    so that each term is exercised."""
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(seed), jcfg,
                                                 1))
    rng = np.random.RandomState(seed)

    def shake(tree, keys, scale):
        for k in keys:
            if k in tree:
                tree[k] = (rng.randn(*tree[k].shape) * scale).astype(
                    np.float32)

    for block in [jp["layers"], jp.get("shared_attn")]:
        if block is None:
            continue
        shake(block, ("ln", "ln1", "ln2"), .1)
        if "mamba" in block:
            shake(block["mamba"], ("conv_b", "dt_bias", "norm_w"), .2)
        if "attn" in block:
            shake(block["attn"], ("bq", "bk", "bv"), .2)
    jp["final_norm"] = (rng.randn(*jp["final_norm"].shape) * .1).astype(
        np.float32)
    return jp


@pytest.fixture(scope="module")
def weights():
    """{case: (reference numpy weights, the port's copy)}."""
    out = {}
    for name, (arch, window) in CASES.items():
        jcfg, cfg = configs(arch, window)
        jp = _jax_weights(jcfg, 3)
        out[name] = jp, params_from_jax(jp, cfg)
    return out


def _tokens(vocab, B, seq, seed=1):
    return np.random.default_rng(seed).integers(
        1, vocab, size=(B, seq)).astype(np.int32)


# ---------------------------------------------------------------------------
# the hybrid stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [8, 13])          # one chunk; ragged
def test_hybrid_forward_and_prefill_match_jax(weights, seq):
    """The 4-layer smoke stack at period 2: the shared block after layers
    1 and 3, in the forward and in build_prefill."""
    jcfg, cfg = configs(ARCH)
    jp, params = weights["zamba2"]
    tokens = _tokens(cfg.vocab, 2, seq)
    h, aux = T.forward(Comm(), cfg, params, t(tokens).long())
    jh, _ = JT.forward(jcomm(), jcfg, jax.tree.map(jnp.asarray, jp),
                       jnp.asarray(tokens))
    close(h, jh)
    assert float(aux) == 0.0
    logits = sstep.build_prefill(cfg)(params, {"tokens": t(tokens).long()})
    jlogits = JT.prefill(jcomm(), jcfg, jax.tree.map(jnp.asarray, jp),
                         jnp.asarray(tokens))
    assert logits.shape == (2, 1, cfg.vocab) and logits.grad_fn is None
    close(logits, jlogits)


def test_hybrid_applies_the_shared_block_after_every_segment(weights):
    """38 layers at period 6 give 7 applications, the last after the
    short segment of layers 36-37; the smoke stack gives 2."""
    _, cfg = configs(ARCH)
    _, params = weights["zamba2"]
    seen = []
    real = T._attn_block

    def spy(comm, cfg_, bp, x, positions):
        seen.append(bp is params["shared_attn"])
        return real(comm, cfg_, bp, x, positions)

    with mock.patch.object(T, "_attn_block", spy):
        T.forward(Comm(), cfg, params, torch.ones(1, 8, dtype=torch.long))
    assert seen == [True, True]
    full = get_config(ARCH)
    assert T.n_shared_blocks(full) == 7
    assert [i for i in range(full.n_layers) if T._shared_after(full, i)] \
        == [5, 11, 17, 23, 29, 35, 37]


def test_hybrid_loss_and_every_gradient_leaf_match_jax(weights):
    """train_loss and each gradient leaf, the shared block's summed over
    its applications, against `jax.value_and_grad(train_loss)`."""
    jcfg, cfg = configs(ARCH)
    jp, params = weights["zamba2"]
    tokens = _tokens(cfg.vocab, 2, 12, seed=4)
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


# ---------------------------------------------------------------------------
# caches and decode
# ---------------------------------------------------------------------------

JDT = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float32): torch.float32}


@pytest.mark.parametrize("case", list(CASES))
def test_init_cache_matches_the_references_tree(case):
    """The tree, every leaf's shape and dtype (bf16 activations, f32 SSM
    state), zeros, at the default dtypes; a windowed cache holds
    min(cache_len, window) slots."""
    arch, window = CASES[case]
    jcfg = jax_smoke(arch, window=window)
    cfg = smoke_config(arch, window=window)
    B, S = 3, 16
    jc = jax.eval_shape(lambda: JT.init_cache(jcfg, 1, B, S))
    cache = T.init_cache(cfg, 1, B, S, device="cpu")
    assert set(cache) == set(jc)
    for part, stacked in jc.items():
        assert len(cache[part]) == jax.tree.leaves(stacked)[0].shape[0]
        for one in cache[part]:
            assert set(one) == set(stacked)
            for k, s in stacked.items():
                assert tuple(one[k].shape) == s.shape[1:], (part, k)
                assert one[k].dtype == JDT[s.dtype], (part, k)
                assert not one[k].any()
    if window is not None:
        assert cache["layers"][0]["k"].shape[1] == window


@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_match_jax(weights, case):
    """Teacher-forced decode_step, 12 steps: the logits and every cache
    leaf against the reference's build_decode_step at each step (the ring
    case wraps its 5 slots twice)."""
    arch, window = CASES[case]
    jcfg, cfg = configs(arch, window)
    jp, params = weights[case]
    B, steps, S = 2, 12, 16
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
        close(lg, jl)
        for part, stacked in jcache.items():
            for i, one in enumerate(cache[part]):
                for k, v in one.items():
                    close(v, stacked[k][i], err_msg=f"{step} {part} {i} {k}")


@pytest.mark.parametrize("arch", [ARCH, DENSE])     # group 1; group 3
@pytest.mark.parametrize("layout", ["plain", "window", "ring"])
def test_attention_decode_and_cache_attend_match_jax(weights, arch, layout):
    """One attention_decode against a cache of random contents: a plain
    cache, a window of 4 narrower than its 12 slots, and a ring of 6
    slots at positions past 6; the output and the new cache.  Then
    `_cache_attend` alone on the same cache and mask."""
    window, S, positions = {"plain": (None, 12, [3, 9]),
                            "window": (4, 12, [3, 9]),
                            "ring": (6, 6, [7, 13])}[layout]
    jcfg, cfg = configs(arch, window)
    jp, params = weights["zamba2" if arch == ARCH else "qwen2"]
    if arch == ARCH:
        jattn, attn = jp["shared_attn"]["attn"], params["shared_attn"]["attn"]
    else:
        jattn = jax.tree.map(lambda a: a[1], jp["layers"]["attn"])
        attn = params["layers"][1]["attn"]
    rng = np.random.RandomState(5)
    B, K, hd = 2, cfg.n_kv_heads, cfg.hd
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    ck, cv = (rng.randn(B, S, K, hd).astype(np.float32) for _ in range(2))
    pos = np.asarray(positions, np.int32)
    cache = {"k": t(ck), "v": t(cv)}
    got, new = L.attention_decode(Comm(), cfg, attn, t(x), cache,
                                  t(pos).long())
    want, jnew = JL.attention_decode(
        jcomm(), jcfg, jax.tree.map(jnp.asarray, jattn), jnp.asarray(x),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.asarray(pos))
    close(got, want)
    assert new is cache                          # written in place
    for k in ("k", "v"):
        close(new[k], jnew[k])
    slot = pos % S if layout == "ring" else pos
    changed = (new["k"] != t(ck)).any(-1).any(-1)
    assert changed.nonzero().tolist() == [[b, s] for b, s in enumerate(slot)]

    q = rng.randn(B, 1, cfg.n_heads, hd).astype(np.float32)
    valid = rng.rand(B, S) < 0.6
    valid[:, 0] = True
    got = L._cache_attend(cfg, t(q), t(ck), t(cv), t(valid))
    want = JL._cache_attend(jcfg, jnp.asarray(q), jnp.asarray(ck),
                            jnp.asarray(cv), jnp.asarray(valid))
    close(got, want)


def test_attention_decode_past_the_cache_writes_its_last_slot():
    """A position past a plain cache's end lands in the last slot, as
    the reference's dynamic_update_slice clamps it, rather than
    indexing out of bounds."""
    cfg = smoke_config(DENSE, dtype=torch.float32)
    params = T.init_params(cfg, seed=0, device="cpu")
    cache = T.init_cache(cfg, 1, 1, 4, device="cpu")["layers"][0]
    L.attention_decode(Comm(), cfg, params["layers"][0]["attn"],
                       torch.randn(1, 1, cfg.d_model), cache,
                       torch.tensor([9]))
    assert cache["k"][0, :3].eq(0).all() and cache["k"][0, 3].ne(0).any()


@pytest.mark.parametrize("arch", [ARCH, DENSE])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.12)])
def test_decode_matches_forward(arch, dtype, tol):
    """tests/test_models.py::test_decode_matches_forward[zamba2-1.2b] and
    [qwen2-0.5b] in the port: teacher-forced decode logits (the attention
    caches, the Mamba2 recurrence) equal the full forward's at every
    step; bf16 at that test's 0.12."""
    cfg = smoke_config(arch, dtype=dtype)
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
    assert max(errs) < tol, errs


def test_multi_device_decode_names_slice_5():
    """The sequence-sharded cache (slice 5c-3b) on one device: each
    attention cache holds cache_len / seq_shards slots, the rows of shard
    0 of the data axis (one PE, so the softmax combine is the
    identity); at positions inside it `attention_decode` with seq_shards
    2 gives the unsharded decode on a cache of those slots, bit for bit,
    and writes the same rows."""
    cfg = smoke_config(DENSE, dtype=torch.float32)
    sharded = T.init_cache(cfg, 1, 2, 8, seq_shards=2, device="cpu")
    assert [tuple(c["k"].shape) for c in sharded["layers"]] \
        == [(2, 4, cfg.n_kv_heads, cfg.hd)] * cfg.n_layers
    whole = T.init_cache(cfg, 1, 2, 4, device="cpu")
    p = T.init_params(cfg, seed=0, device="cpu")["layers"][0]["attn"]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in range(4):
            x = torch.randn(2, 1, cfg.d_model, generator=gen)
            pos = torch.full((2,), t)
            got, _ = L.attention_decode(Comm(), cfg, p, x,
                                        sharded["layers"][0], pos,
                                        seq_shards=2)
            want, _ = L.attention_decode(Comm(), cfg, p, x,
                                         whole["layers"][0], pos)
            assert torch.equal(got, want), t
    for k in ("k", "v"):
        assert torch.equal(sharded["layers"][0][k], whole["layers"][0][k])
    # the replicated-KV plan at tp 2 (3 q heads over 1 kv head) is ported
    # with the serve engine at tp > 1 (slice 5c-3a): the cache stores the
    # one distinct kv head each rank's q heads read
    got = L.init_attn_cache(dataclasses.replace(cfg, n_heads=3, n_kv_heads=1),
                            2, 1, 8, "cpu")
    assert tuple(got["k"].shape) == (1, 8, 1, cfg.hd)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

def test_param_shapes_and_count_match_jax():
    for jcfg, cfg in [configs(ARCH), (jax_smoke(ARCH), smoke_config(ARCH))]:
        params = T.init_params(cfg, seed=0, device="cpu")
        jshapes = jax.eval_shape(
            lambda: JT.init_params(jax.random.key(0), jcfg, 1))
        got = jax.tree_util.tree_flatten_with_path(
            params_to_jax(params, cfg))[0]
        want = jax.tree_util.tree_flatten_with_path(jshapes)[0]
        assert [(k, a.shape) for k, a in got] \
            == [(k, s.shape) for k, s in want]
        assert cfg.param_count() == jcfg.param_count()


def test_full_config_is_the_reference_config():
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    assert cfg.param_count() == jcfg.param_count() == 1170228608
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab", "attn", "window",
              "hybrid_attn_period", "tie_embeddings", "qkv_bias",
              "rope_theta", "remat", "microbatches"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(jcfg.ssm)
    smoke, jsmoke = smoke_config(ARCH), jax_smoke(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "hybrid_attn_period", "remat"):
        assert getattr(smoke, f) == getattr(jsmoke, f), f
    assert dataclasses.asdict(smoke.ssm) == dataclasses.asdict(jsmoke.ssm)
    d_in, heads, _ = L._mamba_split(cfg, 1)
    assert (d_in, heads, cfg.ssm.state) == (4096, 64, 64)
    run = zamba2_1_2b.SERVE_RUN
    assert (run["prefill_len"], run["cache_len"], run["long_cache_len"]) \
        == (32768, 128, 32768)


@pytest.mark.parametrize("arch", [ARCH, DENSE])
def test_dense_cache_sizes_follow_the_window(arch):
    """Counted from shapes (on the meta device): the shared caches of the
    full zamba2 at SERVE_RUN's long decode, 7 x 4 x 32768 x 32 heads x 64
    x k and v x bf16 = 7.5 GB; qwen2 with a window of 4096 keeps 4096 of
    32768 slots."""
    if arch == ARCH:
        run = zamba2_1_2b.SERVE_RUN
        cache = T.init_cache(get_config(ARCH), 1, run["long_batch"],
                             run["long_cache_len"], device="meta")
        nbytes = sum(c[k].numel() * c[k].element_size()
                     for c in cache["shared"] for k in "kv")
        assert len(cache["shared"]) == 7 and len(cache["layers"]) == 38
        assert nbytes == 7 * 4 * 32768 * 32 * 64 * 2 * 2
    else:
        cfg = dataclasses.replace(get_config(DENSE), window=4096)
        cache = T.init_cache(cfg, 1, 1, 32768, device="meta")
        assert cache["layers"][0]["k"].shape == (1, 4096, 2, 64)


# ---------------------------------------------------------------------------
# launcher and entry points
# ---------------------------------------------------------------------------

def test_launch_serve_decode_loop_gives_the_reference_shapes(capsys):
    argv = ["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len", "5",
            "--tokens", "4"]
    gen = launch_serve.main(argv + ["--device", "cpu"])
    jgen = jserve.main(argv)
    assert gen.shape == jgen.shape == (3, 4)
    assert gen.dtype == np.asarray(jgen).dtype
    assert ((gen >= 0) & (gen < smoke_config(ARCH).vocab)).all()
    assert "(dense loop, cpu) generated (3, 4)" in capsys.readouterr().out


def test_launch_serve_defaults_size_the_caches_by_cache_len():
    """The reference's defaults: batch 4, 16 tokens, caches of
    --cache-len 128 slots (not prompt + tokens); a --cache-len below the
    positions the loop decodes is refused."""
    real, seen = T.init_cache, []

    def spy(cfg, tp, batch, cache_len, *a, **kw):
        seen.append((batch, cache_len))
        return real(cfg, tp, batch, cache_len, *a, **kw)

    with mock.patch.object(T, "init_cache", spy):
        gen = launch_serve.main(["--arch", ARCH, "--smoke", "--device",
                                 "cpu"])
    assert gen.shape == (4, 16) and seen == [(4, 128)]
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--cache-len", "40"])


def test_decode_loop_serves_the_dense_family():
    """The launcher's dense-cache loop on the dense family (the launcher
    itself sends it to the paged engine): the generated ids are the
    greedy tokens of build_decode_step on the same weights."""
    cfg = smoke_config(DENSE)
    args = argparse.Namespace(batch=2, prompt_len=4, tokens=3, cache_len=16)
    gen = launch_serve._decode_loop(cfg, torch.device("cpu"), args)
    prompt = np.random.default_rng(0).integers(1, cfg.vocab, size=(2, 4),
                                               dtype=np.int32)
    params = T.init_params(cfg, seed=0, device="cpu")
    cache = T.init_cache(cfg, 1, 2, 16, device="cpu")
    decode = sstep.build_decode_step(cfg)
    seq = t(prompt).long()
    for step in range(6):
        lg, cache = decode(params, cache, {"tokens": seq[:, step:step + 1],
                                           "positions": torch.full((2,),
                                                                   step)})
        if step >= 3:
            seq = torch.cat([seq, lg[:, 0].argmax(-1)[:, None]], 1)
    np.testing.assert_array_equal(gen, seq[:, 4:].numpy())


def test_unported_dense_cache_families_name_their_slice():
    """Every family with a decode step has its dense-cache decode: vlm
    since slice 4c-4 (tests/test_torch_audio_vlm.py), gemma2's
    local/global pairs since slice 4c-2 (tests/test_torch_dense_family.py)
    and the moe family since slice 4c-3 (tests/test_torch_moe.py).  The
    audio encoder has none: init_cache and decode_step raise ValueError,
    as the reference's do."""
    pairs = dataclasses.replace(smoke_config(DENSE), local_global_period=2,
                                local_window=4)
    assert len(T.init_cache(pairs, 1, 2, 8, device="cpu")["layers"]) == 2
    vlm = dataclasses.replace(smoke_config(DENSE), family="vlm")
    assert len(T.init_cache(vlm, 1, 2, 8, device="cpu")["layers"]) \
        == vlm.n_layers
    audio = smoke_config("hubert-xlarge")
    with pytest.raises(ValueError, match="audio"):
        T.init_cache(audio, 1, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="audio"):
        T.decode_step(Comm(), audio, {}, {}, torch.zeros(1, 1), None)


ZAMBA_BLOCKED = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None          # any import of them now fails
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serve import step
    cfg = smoke_config("zamba2-1.2b")
    gen = serve.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu"])
    assert gen.shape == (4, 16)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    logits = step.build_prefill(cfg)(params, {"tokens": torch.ones(
        2, 19, dtype=torch.long)})
    assert logits.shape == (2, 1, cfg.vocab) and torch.isfinite(logits).all()
    print("ZAMBA-ALONE-OK")
""")


def test_zamba2_path_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", ZAMBA_BLOCKED], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "ZAMBA-ALONE-OK" in r.stdout
