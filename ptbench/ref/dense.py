"""The dense decoder family of the benchmark: the weights a run makes
from its seed, the tree the port takes them in, what the port must run
for this reference to hold, and the plain float32 forward, frozen for
the benchmark.  A configuration names its family by `"reference"`; the
harness finds this module, and `counts/dense.py`, by that name.

The forward: token embedding, then per layer RMSNorm -> GQA causal
attention with RoPE -> residual, RMSNorm -> SwiGLU MLP -> residual; a
final RMSNorm and an untied LM head.  It follows the configuration file
(`configs/<name>.json`: the keys as the published HF configs name them,
with the values as run): the norm scale is stored as its offset from 1
(x * rsqrt(mean(x^2) + eps) * (1 + w)), RoPE rotates the two halves of
each head at `rope_theta` with no scaling, and query head j reads
key/value head j // (Hq / Hkv).  Every product is float32 with TF32 off
(`full_f32`), the weights read from the stacked dict of `make_weights`
and cast up a layer at a time, and the attention computed a block of
queries at a time, so that it fits beside the served weights.

`fp8=True` is the comparison's control: every matmul of the linear
layers and of the LM head takes its operands rounded to float8 e4m3
(per row of activations and per output column of weights, each scaled to
the format's range), the precision below the configurations' bfloat16.

Nothing here imports the port: `program_tree` only arranges the same
tensors, and `check_program` reads the fields of the port's config.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..traffic import seed_bits

F8_MAX = 448.0
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# the configuration file's keys and the port's ModelConfig fields they set
PROGRAM_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
                  "num_attention_heads": "n_heads",
                  "num_key_value_heads": "n_kv_heads", "head_dim": "hd",
                  "intermediate_size": "d_ff", "vocab_size": "vocab",
                  "rope_theta": "rope_theta"}


def make_weights(arch: dict, seed: int, device) -> dict:
    """The weights of a run, made on the device from the run's seed.

    The leaves are drawn stacked over the layers, one `torch.randn` call
    a kind of leaf (a few large calls in all), in the dtype they are
    served in (`torch_dtype`), from a `torch.Generator` on the device,
    and scaled as the port's own initialiser scales them (1/sqrt(fan-in);
    the output projections by 1/sqrt(Hq x hd) and 1/sqrt(ff)).  The norm
    scales are drawn too (0.1 x N(0, 1) about 1, as the port stores a
    norm scale as its offset from 1), so that the comparison sees every
    leaf."""
    d, L = arch["hidden_size"], arch["num_hidden_layers"]
    hq, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    hd = arch.get("head_dim") or d // hq
    ff, V = arch["intermediate_size"], arch["vocab_size"]
    wdt = DTYPES[arch["torch_dtype"]]
    gen = torch.Generator(device=device).manual_seed(seed_bits(seed))

    def draw(shape, scale, dtype=wdt):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(scale)

    s_in = 1.0 / math.sqrt(d)
    return {"embed": draw((V, d), s_in), "head": draw((d, V), s_in),
            "final_norm": draw((d,), 0.1, torch.float32),
            "ln1": draw((L, d), 0.1), "ln2": draw((L, d), 0.1),
            "wq": draw((L, d, hq * hd), s_in),
            "wk": draw((L, d, hkv * hd), s_in),
            "wv": draw((L, d, hkv * hd), s_in),
            "wo": draw((L, hq * hd, d), 1.0 / math.sqrt(hq * hd)),
            "w_gate": draw((L, d, ff), s_in), "w_up": draw((L, d, ff), s_in),
            "w_down": draw((L, ff, d), 1.0 / math.sqrt(ff))}


def program_tree(w: dict) -> dict:
    """The port's parameter tree (`ServeEngine(params=...)`) over the
    same storage (views, no copy)."""
    layers = [{"ln1": w["ln1"][i], "ln2": w["ln2"][i],
               "attn": {k: w[k][i] for k in ("wq", "wk", "wv", "wo")},
               "mlp": {k: w[k][i] for k in ("w_gate", "w_up", "w_down")}}
              for i in range(w["wq"].shape[0])]
    return {"embed": {"table": w["embed"], "head": w["head"]},
            "final_norm": w["final_norm"], "layers": layers}


def check_program(cfg, arch: dict) -> None:
    """Raises if the port's config runs other sizes than the file states,
    or attention features this reference does not compute."""
    for key, field in PROGRAM_FIELDS.items():
        want = arch.get(key) or (arch["hidden_size"]
                                 // arch["num_attention_heads"])
        if getattr(cfg, field) != want:
            raise ValueError(f"{cfg.name}: {field}={getattr(cfg, field)}, "
                             f"the configuration file states {key}={want}")
    extras = {"qkv_bias": False, "tie_embeddings": False, "window": None,
              "local_global_period": None, "softcap": None,
              "final_softcap": None, "attn": "gqa", "causal": True}
    for field, want in extras.items():
        if getattr(cfg, field) != want:
            raise ValueError(f"{cfg.name}: {field}={getattr(cfg, field)}; "
                             f"the dense reference computes {want}")


@contextlib.contextmanager
def full_f32():
    """Float32 matmuls at full precision (no TF32) for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _f8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3, scaled by its max along `dim`."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _lin(x, w, fp8: bool):
    w = w.float()
    if fp8:
        return _f8(x, -1) @ _f8(w, 0)
    return x @ w


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def _rope(x, theta: float):
    """x: (N, H, D) at positions 0..N-1, the halves rotated."""
    n, _, dim = x.shape
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(n, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attend(q, k, v, qblock: int):
    """Causal softmax attention, q (N, Hq, D), k and v (N, Hq, D) ->
    (N, Hq, D), a block of queries at a time."""
    n, _, dim = q.shape
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(dim)
    keys = torch.arange(n, device=q.device)
    for s in range(0, n, qblock):
        e = min(n, s + qblock)
        sc = torch.einsum("qhd,khd->hqk", q[s:e], k[:e]) * scale
        sc = sc.masked_fill(keys[None, None, :e] > keys[s:e, None][None],
                            float("-inf"))
        out[s:e] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), v[:e])
    return out


def logits(w: dict, arch: dict, tokens: torch.Tensor, first: int, *,
           fp8: bool = False, qblock: int = 1024) -> torch.Tensor:
    """float32 logits (N - first, V) at positions first..N-1 of one
    sequence of token ids (N,)."""
    d, n = arch["hidden_size"], tokens.shape[0]
    hq, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    hd = arch.get("head_dim") or d // hq
    eps, theta = arch["rms_norm_eps"], arch["rope_theta"]
    group = hq // hkv
    with full_f32(), torch.no_grad():
        x = w["embed"][tokens].float()
        for i in range(arch["num_hidden_layers"]):
            h = _rms(x, w["ln1"][i], eps)
            q = _rope(_lin(h, w["wq"][i], fp8).view(n, hq, hd), theta)
            k = _rope(_lin(h, w["wk"][i], fp8).view(n, hkv, hd), theta)
            v = _lin(h, w["wv"][i], fp8).view(n, hkv, hd)
            k = k.repeat_interleave(group, dim=1)
            v = v.repeat_interleave(group, dim=1)
            o = _attend(q, k, v, qblock).reshape(n, hq * hd)
            x = x + _lin(o, w["wo"][i], fp8)
            h = _rms(x, w["ln2"][i], eps)
            g = _lin(h, w["w_gate"][i], fp8)
            x = x + _lin(g * torch.sigmoid(g) * _lin(h, w["w_up"][i], fp8),
                         w["w_down"][i], fp8)
        x = _rms(x[first:], w["final_norm"], eps)
        return _lin(x, w["head"], fp8)
