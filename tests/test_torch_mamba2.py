"""The port's ssm family (mamba2) on the CPU against the JAX package, on
the same weights (`params_from_jax`) and numpy inputs, in f32 at rtol
1e-4, atol 1e-5: the Mamba2 layer and its decode recurrence, the
forward, prefill and decode entries, the parameter round trip, the
launcher's dense-cache decode loop, and the port's own invariants.

The JAX functions run outside shard_map through a `Comm` whose model
axis is None (size 1), the port's through its one-device `Comm`."""
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
from repro_torch.configs import mamba2_2_7b
from repro_torch.core import Profiler, Tuner
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.parallel.comm import Comm
from repro_torch.serve import step as sstep

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-2.7b"
TOL = dict(rtol=1e-4, atol=1e-5)
JCFG = jax_smoke(ARCH, dtype=jnp.float32)
CFG = smoke_config(ARCH, dtype=torch.float32)


def jcomm():
    return JComm(JAxisSpec(model=None), "xla")


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, **kw):
    np.testing.assert_allclose(a.detach().float().numpy(),
                               np.asarray(b, np.float32), **(kw or TOL))


@pytest.fixture(scope="module")
def weights():
    """The reference's smoke weights (numpy) and the port's copy, with
    nonzero conv_b, dt_bias and norm_w so every term is exercised."""
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(3), JCFG, 1))
    rng = np.random.RandomState(0)
    m = jp["layers"]["mamba"]
    for k in ("conv_b", "dt_bias", "norm_w"):
        m[k] = (rng.randn(*m[k].shape) * .2).astype(np.float32)
    jp["layers"]["ln"] = (rng.randn(*jp["layers"]["ln"].shape) * .1
                          ).astype(np.float32)
    return jp, params_from_jax(jp, CFG)


def _layer0(jp):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), jp["layers"]["mamba"])


def _tokens(B, seq, seed=1):
    return np.random.default_rng(seed).integers(
        1, CFG.vocab, size=(B, seq)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [8, 20])          # one chunk; ragged 3
def test_mamba2_layer_matches_jax(weights, seq):
    jp, params = weights
    x = np.random.RandomState(2).randn(2, seq, CFG.d_model).astype(np.float32)
    got = L.mamba2(Comm(), CFG, params["layers"][0]["mamba"], t(x))
    want = JL.mamba2(jcomm(), JCFG, _layer0(jp), jnp.asarray(x))
    close(got, want)


def test_mamba2_decode_matches_jax(weights):
    jp, params = weights
    rng = np.random.RandomState(3)
    x = rng.randn(2, 1, CFG.d_model).astype(np.float32)
    jcache = jax.tree.map(np.asarray, JL.init_mamba_cache(JCFG, 1, 2))
    cache = {k: (rng.randn(*v.shape) * .5).astype(np.float32)
             for k, v in jcache.items()}         # a nonzero history
    got, new = L.mamba2_decode(Comm(), CFG, params["layers"][0]["mamba"],
                               t(x), {k: t(v) for k, v in cache.items()})
    want, jnew = JL.mamba2_decode(jcomm(), JCFG, _layer0(jp), jnp.asarray(x),
                                  jax.tree.map(jnp.asarray, cache))
    close(got, want)
    for k in ("conv", "ssm"):
        assert new[k].shape == jnew[k].shape and new[k].dtype == torch.float32
        close(new[k], jnew[k])


def test_mamba2_hands_ops_ssd_strided_views(weights, monkeypatch):
    """x, B and C reach the SSD scan as views of the conv output (what the
    kernel takes without a copy), with A = -exp(a_log)."""
    _, params = weights
    seen = {}
    real = ops.ssd

    def spy(x, dt, a_log, b_mat, c_mat, h0=None, *, chunk):
        seen.update(x=x, b=b_mat, c=c_mat, a=a_log, chunk=chunk)
        return real(x, dt, a_log, b_mat, c_mat, h0, chunk=chunk)

    monkeypatch.setattr(L.kops, "ssd", spy)
    x = torch.randn(1, 16, CFG.d_model)
    L.mamba2(Comm(), CFG, params["layers"][0]["mamba"], x)
    s = CFG.ssm
    assert seen["chunk"] == s.chunk
    assert not seen["x"].is_contiguous()
    assert seen["x"].stride()[2:] == (s.head_dim, 1)
    assert seen["b"].stride()[2:] == (s.state, 1)
    assert seen["x"].data_ptr() != seen["b"].data_ptr()
    torch.testing.assert_close(
        seen["a"], -torch.exp(params["layers"][0]["mamba"]["a_log"]))


# ---------------------------------------------------------------------------
# model entries
# ---------------------------------------------------------------------------

def test_forward_and_prefill_logits_match_jax(weights):
    jp, params = weights
    tokens = _tokens(2, 13)
    h, aux = T.forward(Comm(), CFG, params, t(tokens).long())
    jh, _ = JT.forward(jcomm(), JCFG, jax.tree.map(jnp.asarray, jp),
                       jnp.asarray(tokens))
    close(h, jh)
    assert float(aux) == 0.0
    logits = sstep.build_prefill(CFG)(params, {"tokens": t(tokens).long()})
    jlogits = JT.prefill(jcomm(), JCFG, jax.tree.map(jnp.asarray, jp),
                         jnp.asarray(tokens))
    assert logits.shape == (2, 1, CFG.vocab)
    assert logits.grad_fn is None
    close(logits, jlogits)


def test_decode_steps_match_jax(weights):
    """Teacher-forced decode_step logits and caches, step by step, against
    the reference's build_decode_step on the same weights."""
    jp, params = weights
    tokens = _tokens(2, 6)
    jparams = jax.tree.map(jnp.asarray, jp)
    jcache = JT.init_cache(JCFG, 1, 2, 8)
    jdecode = jstep.build_decode_step(JCFG, JAxisSpec(model=None), "xla")
    cache = T.init_cache(CFG, 1, 2, 8, device="cpu")
    decode = sstep.build_decode_step(CFG)
    for step in range(tokens.shape[1]):
        batch = {"tokens": tokens[:, step:step + 1],
                 "positions": np.full((2,), step, np.int32)}
        jl, jcache = jdecode(jparams, jcache,
                             {k: jnp.asarray(v) for k, v in batch.items()})
        lg, cache = decode(params, cache,
                           {k: t(v).long() for k, v in batch.items()})
        close(lg, jl)
    for i, c in enumerate(cache["layers"]):
        close(c["ssm"], jcache["layers"]["ssm"][i])
        close(c["conv"], jcache["layers"]["conv"][i])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.12)])
def test_decode_matches_forward(dtype, tol):
    """tests/test_models.py::test_decode_matches_forward[mamba2-2.7b] in
    the port: teacher-forced decode logits (the one-step recurrence) equal
    the full forward's (the chunked SSD) at every step; bf16 at that
    test's 0.12."""
    cfg = smoke_config(ARCH, dtype=dtype)
    params = T.init_params(cfg, seed=1, device="cpu")
    B, steps = 2, 12
    tokens = t(_tokens(B, steps, seed=0)).long()
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


def test_param_shapes_and_count_match_jax():
    for jcfg, cfg in [(JCFG, CFG), (jax_smoke(ARCH), smoke_config(ARCH))]:
        params = T.init_params(cfg, seed=0, device="cpu")
        jshapes = jax.eval_shape(
            lambda: JT.init_params(jax.random.key(0), jcfg, 1))
        assert set(params["layers"][0]) == {"mamba", "ln"}
        for k, v in jshapes["layers"]["mamba"].items():
            assert tuple(params["layers"][0]["mamba"][k].shape) == \
                v.shape[1:], k
        n = sum(w.numel() for w in jax.tree_util.tree_leaves(params))
        assert n == sum(int(np.prod(s.shape))
                        for s in jax.tree_util.tree_leaves(jshapes))
        assert cfg.param_count() == jcfg.param_count()


def test_full_config_is_the_reference_config():
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    assert cfg.param_count() == jcfg.param_count()
    for f in ("n_layers", "d_model", "vocab", "attn", "family",
              "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    s, js = cfg.ssm, jcfg.ssm
    assert (s.state, s.head_dim, s.n_groups, s.expand, s.chunk,
            s.conv_width) == (js.state, js.head_dim, js.n_groups, js.expand,
                              js.chunk, js.conv_width) == (128, 64, 1, 2,
                                                           128, 4)
    d_in, heads, _ = L._mamba_split(cfg, 1)
    assert (d_in, heads) == (5120, 80)
    assert mamba2_2_7b.SERVE_RUN["prefill_len"] == 32768


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "qwen2-0.5b", "zamba2-1.2b"])
def test_params_round_trip_bit_for_bit(arch):
    jcfg = jax_smoke(arch, dtype=jnp.float32)
    cfg = smoke_config(arch, dtype=torch.float32)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(4), jcfg, 1))
    back = params_to_jax(params_from_jax(jp, cfg), cfg)
    flat, tree = jax.tree_util.tree_flatten(jp)
    bflat, btree = jax.tree_util.tree_flatten(back)
    assert tree == btree
    for a, b in zip(flat, bflat):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


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
    assert ((gen >= 0) & (gen < CFG.vocab)).all()
    assert "(dense loop, cpu) generated (3, 4)" in capsys.readouterr().out


def test_launch_serve_defaults():
    gen = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert gen.shape == (4, 16)                   # batch 4, 16 tokens


def test_init_params_without_a_device_needs_the_card():
    """No entry point defaults to the CPU: without a card, init_params and
    init_cache raise unless device="cpu" is given (init_params made its
    parameters on the CPU before)."""
    cfg = smoke_config(ARCH)
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.init_params(cfg, seed=0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.init_params(smoke_config("qwen2-0.5b"), seed=0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.init_cache(cfg, 1, 2, 8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_serve.main(["--arch", ARCH, "--smoke"])
        assert T.init_params(cfg, seed=0, device="cpu")["embed"][
            "table"].device.type == "cpu"


@pytest.mark.parametrize("family", ["vlm", "gemma2 pairs"])
def test_unported_families_name_their_slice(family):
    """No family is left to a later slice: vlm (with audio, the last two)
    runs since slice 4c-4 (tests/test_torch_audio_vlm.py) and gemma2's
    local/global pairs since slice 4c-2 (moe since 4c-3,
    tests/test_torch_moe.py).  A family the zoo does not have raises
    ValueError naming the families each entry takes, as the reference
    raises ValueError(family)."""
    if family == "gemma2 pairs":
        cfg = dataclasses.replace(smoke_config("qwen2-0.5b"),
                                  local_global_period=2, local_window=4)
    else:
        cfg = smoke_config("phi-3-vision-4.2b")
    params = T.init_params(cfg, seed=0, device="cpu")
    tokens = torch.ones(1, 4, dtype=torch.long)
    assert T.forward(Comm(), cfg, params, tokens)[0].shape \
        == (1, 4, cfg.d_model)
    cache = T.init_cache(cfg, 1, 1, 8, device="cpu")
    T.decode_step(Comm(), cfg, params, cache, tokens[:, :1],
                  torch.zeros(1, dtype=torch.long))
    other = dataclasses.replace(CFG, family="speech")
    with pytest.raises(ValueError, match="takes the dense, ssm"):
        T.init_params(other, seed=0, device="cpu")
    with pytest.raises(ValueError, match="takes the dense, ssm"):
        T.forward(Comm(), other, {}, torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="takes the dense, ssm"):
        T.decode_step(Comm(), other, {}, {}, torch.zeros(1, 1), None)


def test_dense_cache_decode_is_the_ssm_familys():
    """The dense-cache decode takes the ssm family and, since slice 4c-1,
    the dense and hybrid ones: qwen2's init_cache gives a KV cache per
    layer, since slice 4c-2 gemma2's pairs a ring of their local window
    on each local layer, and since slice 4c-4 vlm the dense family's
    caches, while the audio encoder, which has no decode step, raises
    ValueError as the reference's init_cache does."""
    cfg = smoke_config("qwen2-0.5b")
    cache = T.init_cache(cfg, 1, 2, 8, device="cpu")
    assert [tuple(c["k"].shape) for c in cache["layers"]] \
        == [(2, 8, 1, 16)] * cfg.n_layers
    pairs = T.init_cache(dataclasses.replace(cfg, local_global_period=2,
                                             local_window=4),
                         1, 2, 8, device="cpu")
    assert [c["k"].shape[1] for c in pairs["layers"]] == [4, 8]
    vlm = T.init_cache(dataclasses.replace(cfg, family="vlm"), 1, 2, 8,
                       device="cpu")
    assert [tuple(c["k"].shape) for c in vlm["layers"]] \
        == [(2, 8, 1, 16)] * cfg.n_layers
    with pytest.raises(ValueError, match="audio"):
        T.init_cache(smoke_config("hubert-xlarge"), 1, 2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 5"):
        sstep.build_prefill(CFG, topo=object())
    # the tuner and the profiler ride on the step's Comm, as the
    # reference's: accepted, and the one-device step is unchanged
    assert callable(sstep.build_prefill(CFG, tuner=Tuner(),
                                        profile=Profiler()))


MAMBA_BLOCKED = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None          # any import of them now fails
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serve import step
    cfg = smoke_config("mamba2-2.7b")
    gen = serve.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu"])
    assert gen.shape == (4, 16)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    logits = step.build_prefill(cfg)(params, {"tokens": torch.ones(
        2, 19, dtype=torch.long)})
    assert logits.shape == (2, 1, cfg.vocab) and torch.isfinite(logits).all()
    print("MAMBA-ALONE-OK")
""")


def test_mamba2_path_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", MAMBA_BLOCKED], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "MAMBA-ALONE-OK" in r.stdout
