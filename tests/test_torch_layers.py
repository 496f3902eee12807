"""The port's model layers against `repro.models.layers`, in f32 on the
CPU, on the same numpy inputs.

The JAX functions run outside shard_map through a `Comm` whose model
axis is None (size 1), the port's through its one-device `Comm`."""
import dataclasses

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
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.parallel.comm import Comm
from repro_torch.serve import step as sstep

TOL = dict(rtol=1e-5, atol=1e-5)
JCFG = jax_smoke("qwen2-0.5b", dtype=jnp.float32)
CFG = smoke_config("qwen2-0.5b", dtype=torch.float32)
PAGE = 8


def jcomm():
    return JComm(JAxisSpec(model=None), "xla")


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, **kw):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                               **(kw or TOL))


def test_rms_norm():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 48).astype(np.float32)
    w = rng.randn(48).astype(np.float32) * .1
    close(L.rms_norm(t(x), t(w)), JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    pos = rng.randint(0, 300, size=(2, 5)).astype(np.int32)
    close(L.rope(t(x), t(pos).long(), theta),
          JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


def _pool_and_table():
    rng = np.random.RandomState(2)
    pool = rng.randn(8, PAGE, 1, 16).astype(np.float32)
    table = np.array([[3, 5, 1, 0], [2, 7, 0, 0]], np.int32)
    return pool, table


def test_paged_kv_update_and_gather_bitwise():
    pool, table = _pool_and_table()
    rng = np.random.RandomState(3)
    pos = np.stack([np.arange(3, 13), np.arange(0, 10)]).astype(np.int32)
    new = rng.randn(2, 10, 1, 16).astype(np.float32)
    jpool = JL.paged_kv_update(jnp.asarray(pool), jnp.asarray(table),
                               jnp.asarray(new), jnp.asarray(pos), PAGE)
    tpool = L.paged_kv_update(t(pool), t(table).long(), t(new),
                              t(pos).long(), PAGE)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(
        L.paged_kv_gather(tpool, t(table).long()).numpy(),
        np.asarray(JL.paged_kv_gather(jpool, jnp.asarray(table))))


@pytest.mark.parametrize("softcap", [None, 20.0])
def test_attend_mq(softcap):
    jcfg = dataclasses.replace(JCFG, softcap=softcap)
    cfg = dataclasses.replace(CFG, softcap=softcap)
    rng = np.random.RandomState(4)
    q = rng.randn(2, 3, 3, 16).astype(np.float32)
    ck = rng.randn(2, 24, 1, 16).astype(np.float32)
    cv = rng.randn(2, 24, 1, 16).astype(np.float32)
    valid = rng.rand(2, 3, 24) < .6
    valid[..., 0] = True
    close(L._attend_mq(cfg, t(q), t(ck), t(cv), t(valid)),
          JL._attend_mq(jcfg, jnp.asarray(q), jnp.asarray(ck),
                        jnp.asarray(cv), jnp.asarray(valid)))


def _attn_params(jcfg):
    jp = JL.init_attention(jax.random.key(0), jcfg, 1)
    jp = {k: jnp.asarray(np.random.RandomState(5).randn(*v.shape) * .1,
                         jnp.float32) if k.startswith("b") else v
          for k, v in jp.items()}                      # nonzero biases
    return jp, {k: t(v) for k, v in jp.items()}


@pytest.mark.parametrize("variant", [
    dict(), dict(window=5), dict(softcap=20.0), dict(window=9, softcap=30.0)])
def test_attention_paged_prefill(variant):
    """L > 1 attends through ops.attention (the flash kernel's function)."""
    jcfg = dataclasses.replace(JCFG, **variant)
    cfg = dataclasses.replace(CFG, **variant)
    jp, tp_ = _attn_params(jcfg)
    pool, _ = _pool_and_table()
    table = np.array([[3, 5, 1, 0]], np.int32)
    x = np.random.RandomState(6).randn(1, 16, 48).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)[None]
    jy, jnew = JL.attention_paged(
        jcomm(), jcfg, jp, jnp.asarray(x), {"k": jnp.asarray(pool),
                                            "v": jnp.asarray(pool) * 2},
        jnp.asarray(table), jnp.asarray(pos), page_size=PAGE)
    tpool = {"k": t(pool), "v": t(pool) * 2}
    ty, _ = L.attention_paged(Comm(), cfg, tp_, t(x), tpool,
                              t(table).long(), t(pos).long(), page_size=PAGE)
    close(ty, jy)
    for name in ("k", "v"):
        close(tpool[name], jnew[name])


def test_attention_paged_decode():
    jp, tp_ = _attn_params(JCFG)
    pool, table = _pool_and_table()
    x = np.random.RandomState(7).randn(2, 1, 48).astype(np.float32)
    pos = np.array([17, 4], np.int32)
    jy, jnew = JL.attention_paged(
        jcomm(), JCFG, jp, jnp.asarray(x), {"k": jnp.asarray(pool),
                                            "v": jnp.asarray(pool) + 1},
        jnp.asarray(table), jnp.asarray(pos)[:, None], page_size=PAGE)
    tpool = {"k": t(pool), "v": t(pool) + 1}
    ty, _ = L.attention_paged(Comm(), CFG, tp_, t(x), tpool,
                              t(table).long(), t(pos).long()[:, None],
                              page_size=PAGE)
    close(ty, jy)
    for name in ("k", "v"):
        close(tpool[name], jnew[name])


def test_attention_paged_prefill_needs_arange_positions():
    _, tp_ = _attn_params(JCFG)
    pool, _ = _pool_and_table()
    with pytest.raises(ValueError):
        L.attention_paged(Comm(), CFG, tp_, torch.zeros(1, 4, 48),
                          {"k": t(pool), "v": t(pool)},
                          torch.tensor([[3, 5, 1, 0]]),
                          torch.arange(1, 5)[None], page_size=PAGE)


def test_prefill_checks_positions_once_per_stack(monkeypatch):
    """prefill_paged checks positions once (one read-back to the host),
    not once per layer, and still refuses positions other than arange."""
    params = T.init_params(CFG, seed=0, device="cpu")
    pool = T.init_kv_pool(CFG, 1, 8, PAGE, "cpu")
    table = torch.tensor([[3, 5, 0, 0]])
    tokens = torch.arange(1, 17)[None]
    calls = []
    check = L.check_prefill_positions
    monkeypatch.setattr(L, "check_prefill_positions",
                        lambda pos: (calls.append(1), check(pos)))
    T.prefill_paged(Comm(), CFG, params, pool, table, tokens,
                    torch.arange(16)[None], page_size=PAGE)
    assert len(calls) == 1 and CFG.n_layers > 1
    with pytest.raises(ValueError):
        T.prefill_paged(Comm(), CFG, params, pool, table, tokens,
                        torch.arange(1, 17)[None], page_size=PAGE)


def test_embed_lm_logits_mlp():
    jparams = JT.init_params(jax.random.key(1), JCFG, 1)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), CFG)
    tokens = np.array([[1, 5, 127, 128, 1000, 0]], np.int32)  # ids >= vocab
    jx = JL.embed(jcomm(), JCFG, jparams["embed"], jnp.asarray(tokens))
    x = L.embed(Comm(), CFG, params["embed"], t(tokens).long())
    close(x, jx)
    assert not x[0, 3:5].any()                 # out of vocab embeds to 0
    jl0 = jax.tree.map(lambda a: a[0], jparams["layers"])
    close(L.mlp(Comm(), CFG, params["layers"][0]["mlp"], x),
          JL.mlp(jcomm(), JCFG, jl0["mlp"], jx))
    close(L.lm_logits(Comm(), CFG, params["embed"], x),
          JL.lm_logits(jcomm(), JCFG, jparams["embed"], jx))


def test_params_from_jax_layout():
    jparams = jax.tree.map(np.asarray,
                           JT.init_params(jax.random.key(2), JCFG, 1))
    params = params_from_jax(jparams, CFG)
    assert len(params["layers"]) == CFG.n_layers
    for i, layer in enumerate(params["layers"]):
        for k, w in layer["attn"].items():
            np.testing.assert_array_equal(
                w.numpy(), jparams["layers"]["attn"][k][i])
    np.testing.assert_array_equal(params["embed"]["table"].numpy(),
                                  jparams["embed"]["table"])


@pytest.mark.parametrize("arch_cfg", ["smoke", "full"])
def test_init_params_shapes_and_param_count_match_jax(arch_cfg):
    if arch_cfg == "smoke":
        jcfg, cfg = JCFG, CFG
    else:
        jcfg, cfg = jax_config("qwen2-0.5b"), get_config("qwen2-0.5b")
    assert cfg.param_count() == jcfg.param_count()
    jshapes = jax.eval_shape(
        lambda: JT.init_params(jax.random.key(0), jcfg, 1))
    want = {k: tuple(v.shape[1:]) for k, v in
            jax.tree_util.tree_flatten_with_path(jshapes["layers"])[0]}
    if arch_cfg == "smoke":
        params = T.init_params(cfg, seed=0, device="cpu")
        got = {k: tuple(v.shape) for k, v in
               jax.tree_util.tree_flatten_with_path(params["layers"][0])[0]}
        assert got == want
        n = sum(w.numel() for w in jax.tree_util.tree_leaves(params))
        assert n == sum(int(np.prod(s.shape)) for s in
                        jax.tree_util.tree_leaves(jshapes))


def test_sample_greedy_ties_go_to_lowest_index():
    logits = np.zeros((3, 16), np.float32)
    logits[0, [2, 9, 14]] = 5.0               # three-way tie -> 2
    logits[1, :] = 1.0                        # all tied -> 0
    logits[2, 11] = 3.0                       # unique max -> 11
    got = sstep.sample_greedy(Comm(), t(logits))
    assert got.tolist() == np.argmax(logits, -1).tolist() == [2, 0, 11]


def test_comm_is_one_device():
    c = Comm()
    assert c.axis_size(c.axes.model) == 1 and c.axis_index("data") == 0
    x = torch.ones(3)
    assert c.allreduce(x, "model") is x and c.allgather(x, "model") is x
    # outside a rank process there is no mesh: no SPMD net exists
    from repro_torch.core.netops import SpmdNetOps
    assert c.mesh is None
    with pytest.raises(RuntimeError, match="rank process"):
        SpmdNetOps("model")
