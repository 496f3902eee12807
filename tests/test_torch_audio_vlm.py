"""The audio and vlm families in the port — hubert-xlarge (an encoder:
non-causal attention over stub frame embeddings, no decode step) and
phi-3-vision-4.2b (the dense layers, with stub image embeddings over the
first n_frontend_tokens positions) — on the CPU against the JAX package,
on the same weights (`params_from_jax`) and numpy inputs, in f32 at rtol
1e-4, atol 1e-5: forward and prefill (phi-3-vision with and without its
embeds), train_loss with every gradient leaf, phi-3-vision's decode steps
and paged engine, the parameter round trip, the shape cells (`SHAPES`,
`shape_applicable`, `input_specs`) and `make_pipeline`; the launchers;
the reference pipeline's width-1 vision embeds, which its own forward
refuses, beside the port's batch of d_model; the path without jax.

The JAX functions run outside shard_map through a `Comm` whose model axis
is None (size 1), the port's through its one-device `Comm`."""
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

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jax_config
from repro.configs import smoke_config as jax_smoke
from repro.data import pipeline as jpipeline
from repro.launch import serve as jserve
from repro.launch.mesh import make_mesh
from repro.models import config as jconfig
from repro.models import transformer as JT
from repro.parallel.comm import AxisSpec as JAxisSpec
from repro.parallel.comm import Comm as JComm
from repro.serve import step as jstep
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs import hubert_xlarge, phi_3_vision_4_2b
from repro_torch.core.heap import tree_flatten
from repro_torch.data import pipeline
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import config as pconfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.parallel.comm import Comm
from repro_torch.serve import step as sstep
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import optimizer as opt
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
HUBERT, PHI3V = "hubert-xlarge", "phi-3-vision-4.2b"
ARCHS_HERE = [HUBERT, PHI3V]
TOL = dict(rtol=1e-4, atol=1e-5)
JDT = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.int32): torch.int32}


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


@pytest.fixture(scope="module")
def weights():
    """{arch: (reference numpy weights, the port's copy)}, the norms moved
    off zero so that each term is exercised."""
    out = {}
    for arch in ARCHS_HERE:
        jcfg, cfg = configs(arch)
        jp = jax.tree.map(np.asarray,
                          JT.init_params(jax.random.key(3), jcfg, 1))
        rng = np.random.RandomState(3)
        for k in ("ln1", "ln2"):
            jp["layers"][k] = (rng.randn(*jp["layers"][k].shape) * .1
                               ).astype(np.float32)
        jp["final_norm"] = (rng.randn(*jp["final_norm"].shape) * .1
                            ).astype(np.float32)
        out[arch] = jp, params_from_jax(jp, cfg)
    return out


def _inputs(cfg, B, seq, seed=1):
    """A batch of numpy inputs: audio frames (B, seq, d); for vision,
    tokens and frontend embeds (B, nf, d); targets for both."""
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(1, cfg.vocab, size=(B, seq))
           .astype(np.int32)}
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal((B, seq, cfg.d_model)).astype(
            np.float32)
        return out
    out["tokens"] = rng.integers(1, cfg.vocab, size=(B, seq)).astype(
        np.int32)
    out["frontend_embeds"] = rng.standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _port(batch):
    return {k: t(v).long() if v.dtype == np.int32 else t(v)
            for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the full-sequence entries
# ---------------------------------------------------------------------------

CASES = [(HUBERT, "frames"), (PHI3V, "embeds"), (PHI3V, "tokens only")]


@pytest.mark.parametrize("arch,inputs", CASES)
@pytest.mark.parametrize("seq", [8, 12])          # nf = 8: all, or past
def test_forward_and_prefill_match_jax(weights, arch, inputs, seq):
    """forward's hidden state at every position and build_prefill's
    last-position logits against the reference's: hubert from frames;
    phi-3-vision with its frontend embeds (over all 8 positions of an
    8-token prompt, or the first 8 of 12) and with tokens only."""
    jcfg, cfg = configs(arch)
    jp, params = weights[arch]
    batch = _inputs(cfg, 2, seq)
    del batch["targets"]
    if inputs == "tokens only":
        del batch["frontend_embeds"]
    kw = {k: v for k, v in _port(batch).items() if k != "tokens"}
    jkw = {k: v for k, v in _jax(batch).items() if k != "tokens"}
    h, aux = T.forward(Comm(), cfg, params, _port(batch).get("tokens"),
                       **kw)
    jparams = jax.tree.map(jnp.asarray, jp)
    jh, _ = JT.forward(jcomm(), jcfg, jparams, _jax(batch).get("tokens"),
                       **jkw)
    assert h.shape == jh.shape
    close(h, jh)
    assert float(aux) == 0.0
    logits = sstep.build_prefill(cfg)(params, _port(batch))
    jlogits = jstep.build_prefill(jcfg, JAxisSpec(model=None), "xla")(
        jparams, _jax(batch))
    assert logits.shape == (2, 1, cfg.vocab) and logits.grad_fn is None
    close(logits, jlogits)


def test_embeds_replace_the_first_positions(weights):
    """phi-3-vision's embeds reach the output: the hidden state at the
    last position moves with them, and the first nf positions' inputs to
    the first layer are the embeds themselves (cast to cfg.dtype)."""
    _, cfg = configs(PHI3V)
    _, params = weights[PHI3V]
    batch = _port(_inputs(cfg, 2, 12))
    with_e, _ = T.forward(Comm(), cfg, params, batch["tokens"],
                          frontend_embeds=batch["frontend_embeds"])
    without, _ = T.forward(Comm(), cfg, params, batch["tokens"])
    assert (with_e[:, -1] - without[:, -1]).abs().max() > 1e-2
    seen = []
    real = T._attn_block

    def spy(comm, cfg_, bp, x, *a, **kw):
        seen.append(x)
        return real(comm, cfg_, bp, x, *a, **kw)

    with mock.patch.object(T, "_attn_block", spy):
        T.forward(Comm(), cfg, params, batch["tokens"],
                  frontend_embeds=batch["frontend_embeds"])
    nf = cfg.n_frontend_tokens
    assert torch.equal(seen[0][:, :nf], batch["frontend_embeds"])
    assert torch.equal(seen[0][:, nf:], L.embed(
        Comm(), cfg, params["embed"], batch["tokens"])[:, nf:])


def test_hubert_attends_both_ways(weights):
    """hubert calls kernel 4's wrapper non-causal in every layer (the
    reference's cfg.causal = False), and an early position's hidden state
    moves when a later frame changes."""
    _, cfg = configs(HUBERT)
    _, params = weights[HUBERT]
    assert cfg.is_encoder and not smoke_config(PHI3V).is_encoder
    seen = []
    real = L.kops.attention

    def spy(q, k, v, **kw):
        seen.append(kw["causal"])
        return real(q, k, v, **kw)

    frames = _port(_inputs(cfg, 1, 6))["frames"]
    with mock.patch.object(L.kops, "attention", spy):
        h, _ = T.forward(Comm(), cfg, params, frames=frames)
    assert seen == [False] * cfg.n_layers
    later = frames.clone()
    later[:, -1] += 1.0
    h2, _ = T.forward(Comm(), cfg, params, frames=later)
    assert (h2[:, 0] - h[:, 0]).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_loss_and_every_gradient_leaf_match_jax(weights, arch):
    """train_loss and each gradient leaf against
    `jax.value_and_grad(train_loss)`: hubert on frames (its token table,
    which the loss never reads, gets zeros in both), phi-3-vision with its
    embeds."""
    jcfg, cfg = configs(arch)
    jp, params = weights[arch]
    batch = _inputs(cfg, 2, 12, seed=4)
    jl, jg = jax.value_and_grad(lambda p: JT.train_loss(
        jcomm(), jcfg, p, _jax(batch)))(jax.tree.map(jnp.asarray, jp))
    loss, grads = tstep.loss_and_grads(Comm(), cfg, params,
                                       tstep.batch_to_device(batch, "cpu"))
    close(loss, jl)
    got = jax.tree_util.tree_flatten_with_path(params_to_jax(grads, cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   err_msg=str(k), **TOL)
    if arch == HUBERT:
        assert not grads["embed"]["table"].any()


# ---------------------------------------------------------------------------
# phi-3-vision's decode: the dense caches and the paged engine
# ---------------------------------------------------------------------------

def test_phi3v_decode_steps_match_jax_and_forward(weights):
    """Teacher-forced decode_step, 10 steps against caches of 12 slots:
    the logits and every cache leaf against the reference's
    build_decode_step at each step, and the logits against the port's
    full forward over the same tokens (no embeds: a decode step reads
    tokens only)."""
    jcfg, cfg = configs(PHI3V)
    jp, params = weights[PHI3V]
    B, S, steps = 2, 12, 10
    tokens = _inputs(cfg, B, steps)["tokens"]
    jparams = jax.tree.map(jnp.asarray, jp)
    jcache = JT.init_cache(jcfg, 1, B, S)
    jdecode = jstep.build_decode_step(jcfg, JAxisSpec(model=None), "xla")
    cache = T.init_cache(cfg, 1, B, S, device="cpu")
    decode = sstep.build_decode_step(cfg)
    h, _ = T.forward(Comm(), cfg, params, t(tokens).long())
    full = L.lm_logits(Comm(), cfg, params["embed"], h)
    for step in range(steps):
        batch = {"tokens": tokens[:, step:step + 1],
                 "positions": np.full((B,), step, np.int32)}
        jl, jcache = jdecode(jparams, jcache, _jax(batch))
        lg, cache = decode(params, cache, _port(batch))
        close(lg, jl, err_msg=str(step))
        close(lg[:, 0], full[:, step].numpy(), err_msg=str(step))
        for i, one in enumerate(cache["layers"]):
            for k in "kv":
                close(one[k], jcache["layers"][k][i],
                      err_msg=f"{step} {i} {k}")


def test_phi3v_paged_engine_matches_jax_engine():
    """The paged engine on phi-3-vision-smoke in f32, token for token and
    logits at rtol 1e-4/atol 1e-4 (test_torch_serve's rule) against the
    reference's engine on its weights: prompts of tokens only, as both
    engines take them."""
    kw = dict(max_slots=3, page_size=8, max_seq=32, prompt_bucket=16)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 128, size=n).astype(np.int32)
               for n in (5, 9, 3, 12)]
    jeng = JServeEngine(jax_smoke(PHI3V, dtype=jnp.float32),
                        make_mesh(1, 1), capture_logits=True, **kw)
    jrids = [jeng.submit(p, 6) for p in prompts]
    jeng.run()
    _, cfg = configs(PHI3V)
    eng = ServeEngine(cfg, params=params_from_jax(
        jax.tree.map(np.asarray, jeng.params), cfg), device="cpu",
        capture_logits=True, **kw)
    rids = [eng.submit(p, 6) for p in prompts]
    eng.run()
    for rid, jrid in zip(rids, jrids):
        np.testing.assert_array_equal(eng.results[rid], jeng.results[jrid])
        for got, want in zip(eng.logits_trace[rid], jeng.logits_trace[jrid]):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_paged_families_follow_the_reference():
    assert T.paged_families() == JT.paged_families() == ("dense", "vlm")
    pool = T.init_kv_pool(smoke_config(PHI3V), 1, 5, 8, "cpu")
    jpool = jax.eval_shape(lambda: JT.init_kv_pool(jax_smoke(PHI3V), 1, 5,
                                                   8))
    for k in "kv":
        assert tuple(pool[k].shape) == jpool["layers"][k].shape
    with pytest.raises(ValueError, match="audio"):
        T.init_kv_pool(smoke_config(HUBERT), 1, 5, 8, "cpu")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_params_round_trip_bit_for_bit(weights, arch):
    jp, params = weights[arch]
    _, cfg = configs(arch)
    got = jax.tree_util.tree_flatten_with_path(params_to_jax(params, cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(k))
    back = params_from_jax(params_to_jax(params, cfg), cfg)
    for a, b in zip(tree_flatten(back)[0], tree_flatten(params)[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_param_count_and_config_match_the_reference(arch):
    """The smoke tree's size and param_count() equal the reference's; the
    full config's fields too, and its reference tree holds (hubert)
    1,259,705,600 and (phi-3-vision) 3,821,079,552 parameters, 4.69 and
    14.23 GiB in f32."""
    jcfg, cfg = jax_smoke(arch), smoke_config(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    jshapes = jax.eval_shape(lambda: JT.init_params(jax.random.key(0), jcfg,
                                                    1))
    assert sum(w.numel() for w in tree_flatten(params)[0]) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(jshapes))
    assert cfg.param_count() == jcfg.param_count()
    full, jfull = get_config(arch), jax_config(arch)
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab", "causal",
              "frontend", "n_frontend_tokens", "microbatches", "remat",
              "moment_dtype", "rope_theta", "qkv_bias", "tie_embeddings"):
        assert getattr(full, f) == getattr(jfull, f), f
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert JDT[jnp.dtype(jfull.param_dtype)] == full.param_dtype
    tree = jax.eval_shape(lambda: JT.init_params(jax.random.key(0), jfull,
                                                 1))
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(tree))
    assert n == full.param_count() + full.d_model
    assert n == {HUBERT: 1259705600, PHI3V: 3821079552}[arch]
    assert round(n * 4 / 2**30, 2) == {HUBERT: 4.69, PHI3V: 14.23}[arch]


def test_serve_runs_follow_the_reference_shapes():
    """hubert's SERVE_RUN is `prefill_32k` at batch 1 with no decode;
    phi-3-vision's adds the launcher's defaults and `decode_32k`'s 32768
    slots at batch 2, whose caches are 12.0 GiB a row (on the meta
    device)."""
    h, p = hubert_xlarge.SERVE_RUN, phi_3_vision_4_2b.SERVE_RUN
    s = pconfig.SHAPES
    assert (h["prefill_len"], h["prefill_batch"]) \
        == (s["prefill_32k"]["seq_len"], 1)
    assert set(h) == {"prefill_len", "prefill_batch"}
    assert (p["prefill_len"], p["prefill_batch"]) == (32768, 1)
    assert (p["batch"], p["prompt_len"], p["new_tokens"], p["cache_len"]) \
        == (4, 32, 16, 128)
    assert (p["long_cache_len"], p["long_batch"]) \
        == (s["decode_32k"]["seq_len"], 2)
    cache = T.init_cache(get_config(PHI3V), 1, 1, p["long_cache_len"],
                         device="meta")
    row = sum(c[k].numel() * c[k].element_size()
              for c in cache["layers"] for k in "kv")
    assert row == 32 * 2 * 32768 * 32 * 96 * 2 == 12 * 2**30


# ---------------------------------------------------------------------------
# the shape cells and the pipeline
# ---------------------------------------------------------------------------

def test_shapes_and_applicability_match_the_reference():
    """SHAPES and LONG_OK_FAMILIES equal the reference's, and
    shape_applicable agrees for all 10 archs x 4 shapes."""
    assert pconfig.SHAPES == jconfig.SHAPES
    assert pconfig.LONG_OK_FAMILIES == jconfig.LONG_OK_FAMILIES
    assert sorted(ARCHS) == sorted(JARCHS) and len(ARCHS) == 10
    for arch in ARCHS:
        for shape in pconfig.SHAPES:
            assert pconfig.shape_applicable(get_config(arch), shape) \
                == jconfig.shape_applicable(jax_config(arch), shape), \
                (arch, shape)
    assert pconfig.shape_applicable(get_config(HUBERT), "decode_32k") \
        == (False, "encoder-only arch has no decode step")


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_input_specs_match_the_reference(arch):
    """Every input of every shape cell, with and without batch_override:
    the reference's names in its order, its shapes, the dtypes that map
    to its dtypes, and nothing allocated (the meta device)."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape in pconfig.SHAPES:
        for override in (None, 3):
            got = pconfig.input_specs(cfg, shape, batch_override=override)
            want = jconfig.input_specs(jcfg, shape, batch_override=override)
            assert list(got) == list(want), (shape, override)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape, (shape, k)
                assert got[k].dtype == JDT[jnp.dtype(want[k].dtype)]
                assert got[k].device.type == "meta"


@pytest.mark.parametrize("arch", [HUBERT, PHI3V, "gemma2-9b"])
def test_prefill_inputs_follow_input_specs(arch):
    """The card's prefill batch (tools/profile_prefill, chip_smoke) has
    input_specs' names, shapes and dtypes at SERVE_RUN's batch (a smoke
    config here, so frames are narrow); token ids are the numpy draw the
    earlier slices' prompts were made by."""
    from repro_torch.configs.registry import _module
    from repro_torch.tools.profile_prefill import prefill_inputs
    cfg, run = smoke_config(arch), _module(arch).SERVE_RUN
    batch = prefill_inputs(cfg, run, "cpu")
    specs = pconfig.input_specs(cfg, "prefill_32k",
                                batch_override=run["prefill_batch"])
    assert list(batch) == list(specs)
    for k, spec in specs.items():
        assert batch[k].shape == spec.shape
        assert batch[k].dtype == (torch.int64 if k == "tokens"
                                  else spec.dtype)
    if "tokens" in batch:
        want = np.random.default_rng(0).integers(
            1, cfg.vocab, size=(run["prefill_batch"], run["prefill_len"]))
        np.testing.assert_array_equal(batch["tokens"].numpy(), want)


TINY = dict(seq_len=16, global_batch=2, kind="train")


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_make_pipeline_matches_the_reference(arch, monkeypatch):
    """make_pipeline's batches bit for bit against the reference's, on a
    small cell added to both SHAPES (a real cell's batch is GBs), except
    the vision embeds: the port's are (B, nf, d_model), the reference's
    (B, nf, 1) (a reference red).  On the real cells, the same seq_len,
    batch and frontend arguments."""
    monkeypatch.setitem(pconfig.SHAPES, "tiny", TINY)
    monkeypatch.setitem(jconfig.SHAPES, "tiny", TINY)
    cfg, jcfg = smoke_config(arch), jax_smoke(arch)
    pipe = pipeline.make_pipeline(cfg, "tiny", seed=4)
    jpipe = jpipeline.make_pipeline(jcfg, "tiny", seed=4)
    for step in (0, 3):
        got, want = pipe.batch(step), jpipe.batch(step)
        assert list(got) == list(want)
        for k in want:
            if k == "frontend_embeds":
                nf = cfg.n_frontend_tokens
                assert want[k].shape == (2, nf, 1)
                assert got[k].shape == (2, nf, cfg.d_model)
                assert got[k].dtype == want[k].dtype
                continue
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert ("frames" in got) == (cfg.frontend == "audio")
        assert ("frontend_embeds" in got) == (cfg.frontend == "vision")
    for shape in jconfig.SHAPES:
        p = pipeline.make_pipeline(get_config(arch), shape)
        j = jpipeline.make_pipeline(jax_config(arch), shape)
        for f in ("vocab", "seq_len", "global_batch", "seed", "frames_dim",
                  "frontend_tokens"):
            assert getattr(p, f) == getattr(j, f), (shape, f)


def test_synthetic_lm_keeps_the_references_width_by_default():
    """Without frontend_dim the port's SyntheticLM draws the reference's
    width-1 embeds, bit for bit (test_torch_train's
    test_synthetic_lm_batches_identical holds it too); with it, only the
    embeds' width changes: tokens and targets, drawn first, stay the
    same."""
    kw = dict(vocab=50, seq_len=8, global_batch=2, frontend_tokens=3)
    plain = pipeline.SyntheticLM(**kw).batch(1)
    want = jpipeline.SyntheticLM(**kw).batch(1)
    wide = pipeline.SyntheticLM(**kw, frontend_dim=6).batch(1)
    for k in want:
        np.testing.assert_array_equal(plain[k], want[k])
    assert wide["frontend_embeds"].shape == (2, 3, 6)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(wide[k], want[k])


def test_reference_vision_pipeline_batch_fails_in_reference_forward():
    """The reference red: its train launcher's pipeline (no width for the
    embeds) gives a vision config (B, nf, 1) embeds, which the
    reference's own forward cannot concatenate with the (B, L - nf, d)
    token embeddings."""
    jcfg = jax_smoke(PHI3V)
    jpipe = jpipeline.SyntheticLM(
        jcfg.vocab, 24, 2, frames_dim=None,
        frontend_tokens=jcfg.n_frontend_tokens)     # repro/launch/train.py
    batch = jpipe.batch(0)
    assert batch["frontend_embeds"].shape == (2, jcfg.n_frontend_tokens, 1)
    jparams = JT.init_params(jax.random.key(0), jcfg, 1)
    with pytest.raises(TypeError, match="concatenate"):
        JT.train_loss(jcomm(), jcfg, jparams, _jax(batch))


def test_port_trains_on_its_own_vision_batch():
    """Beside it, the port's pipeline for the same config (frontend
    embeds of d_model): one train step, finite loss and parameters, its
    tokens and targets the reference's."""
    cfg = smoke_config(PHI3V)
    pipe = pipeline.SyntheticLM(cfg.vocab, 24, 2,
                                **pipeline.frontend_kwargs(cfg))
    batch = pipe.batch(0)
    want = jpipeline.SyntheticLM(
        cfg.vocab, 24, 2, frontend_tokens=cfg.n_frontend_tokens).batch(0)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(batch[k], want[k])
    assert batch["frontend_embeds"].shape == (2, cfg.n_frontend_tokens,
                                              cfg.d_model)
    params = T.init_params(cfg, seed=0, device="cpu")
    adamw = opt.AdamWConfig(moment_dtype=cfg.moment_dtype)
    loss, params, _ = tstep.build_train_step(cfg, adamw=adamw)(
        params, opt.init_state(params, adamw), batch)
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(w).all() for w in tree_flatten(params)[0])


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def _ones_batch(cfg, B=4, L=32):
    """test_models.py's `_batch`: ones of the arch's inputs."""
    if cfg.frontend == "audio":
        return {"frames": np.ones((B, L, cfg.d_model), np.float32),
                "targets": np.ones((B, L), np.int32)}
    b = {"tokens": np.ones((B, L), np.int32),
         "targets": np.ones((B, L), np.int32)}
    if cfg.frontend == "vision":
        b["frontend_embeds"] = np.ones((B, cfg.n_frontend_tokens,
                                        cfg.d_model), np.float32)
    return b


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_step_smoke(arch):
    """test_models.py::test_train_step_smoke in the port: two steps on the
    same batch of ones, finite losses, the second under 1.5x the first,
    every updated parameter finite."""
    cfg = smoke_config(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    adamw = opt.AdamWConfig(moment_dtype=cfg.moment_dtype)
    step = tstep.build_train_step(cfg, adamw=adamw)
    state = opt.init_state(params, adamw)
    batch = _ones_batch(cfg)
    loss0, params, state = step(params, state, batch)
    loss1, params, state = step(params, state, batch)
    assert np.isfinite(float(loss0)) and np.isfinite(float(loss1))
    assert float(loss1) < float(loss0) * 1.5
    assert all(torch.isfinite(w).all() for w in tree_flatten(params)[0])


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_launch_train_smoke_on_cpu(arch, capsys):
    """The train launcher on the CPU, 2 steps on its own pipeline (frames,
    or tokens with embeds of d_model): finite losses."""
    run = launch_train.run(["--arch", arch, "--smoke", "--device", "cpu",
                            "--steps", "2", "--seq-len", "16", "--batch",
                            "2"])
    assert len(run.losses) == 2 and np.isfinite(run.losses).all()
    assert capsys.readouterr().out.count("[train] step") == 2


def test_launch_serve_exits_for_the_encoder():
    """Both launchers exit for hubert with the reference's SystemExit,
    before any work: the port builds no engine and no parameters."""
    with pytest.raises(SystemExit, match="encoder-only arch has no decode "
                                         "loop"):
        jserve.main(["--arch", HUBERT, "--smoke"])
    with mock.patch.object(T, "init_params") as init, \
            mock.patch.object(launch_serve, "_decode_loop") as loop, \
            pytest.raises(SystemExit, match="encoder-only arch has no "
                                            "decode loop"):
        launch_serve.main(["--arch", HUBERT, "--smoke", "--device", "cpu"])
    assert not init.called and not loop.called
    with pytest.raises(SystemExit, match="encoder-only"):
        launch_serve.main(["--arch", HUBERT])      # before the device check


def test_launch_serve_phi3v_through_the_paged_engine(capsys):
    """phi-3-vision through the launcher's paged engine at the reference's
    defaults: (4, 16) token ids within the vocabulary, the shape the
    reference launcher gives (each draws its own seeded weights, so the
    ids themselves differ; test_phi3v_paged_engine_matches_jax_engine
    holds the engines on shared weights)."""
    gen = launch_serve.main(["--arch", PHI3V, "--smoke", "--device", "cpu"])
    jgen = np.asarray(jserve.main(["--arch", PHI3V, "--smoke"]))
    assert gen.shape == jgen.shape == (4, 16) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < smoke_config(PHI3V).vocab)).all()
    assert "(paged, cpu) generated (4, 16)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# without jax
# ---------------------------------------------------------------------------

BLOCKED = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None          # any import of them now fails
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    from repro_torch.serve import step
    cfg = smoke_config("hubert-xlarge")
    params = transformer.init_params(cfg, seed=0, device="cpu")
    logits = step.build_prefill(cfg)(params, {"frames": torch.ones(
        2, 9, cfg.d_model)})
    assert logits.shape == (2, 1, cfg.vocab)
    assert torch.isfinite(logits).all()
    try:
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
        raise AssertionError("no SystemExit")
    except SystemExit:
        pass
    gen = serve.main(["--arch", "phi-3-vision-4.2b", "--smoke", "--device",
                      "cpu"])
    assert gen.shape == (4, 16)
    for arch in ("hubert-xlarge", "phi-3-vision-4.2b"):
        losses = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--steps", "1", "--seq-len", "12", "--batch",
                             "2"])
        assert len(losses) == 1
    print("AUDIO-VLM-ALONE-OK")
""")


def test_audio_and_vlm_run_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", BLOCKED], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "AUDIO-VLM-ALONE-OK" in r.stdout
