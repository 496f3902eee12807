"""Operations and bytes of a dense decoder (GQA attention, SwiGLU MLP,
untied LM head) from the sizes of `configs/<name>.json`.

`kept_pairs` and `attention_*` are kernel 4's work (the flash-attention
forward of a causal prefill): each kept (query, key) pair costs
2(D + Dv) operations a q head (QK^T and PV), and the bytes are q, k, v
read once and the output written once.  `token_flops` and
`prefill_flops` are the model's: 2 x the non-embedding matmul parameters
a token, attention over the live context, and the LM head once for each
token emitted."""
from __future__ import annotations


def _dims(a: dict):
    d = a["hidden_size"]
    hq, hkv = a["num_attention_heads"], a["num_key_value_heads"]
    hd = a.get("head_dim") or d // hq
    return d, hq, hkv, hd


def kept_pairs(n: int) -> int:
    """Causal (query, key) pairs of an n-token prompt: n(n + 1) / 2."""
    return n * (n + 1) // 2


def attention_flops(a: dict, n: int, layers: int | None = None) -> float:
    """Kernel 4's operations over an n-token causal prefill, every layer
    (or `layers`): kept pairs x 2(D + Dv) x Hq."""
    _, hq, _, hd = _dims(a)
    nl = a["num_hidden_layers"] if layers is None else layers
    return float(kept_pairs(n) * 2 * (hd + hd) * hq * nl)


def attention_bytes(a: dict, n: int, layers: int | None = None,
                    elem: int = 2) -> float:
    """Kernel 4's bytes over an n-token prefill, every layer: q and the
    output (Hq heads), k and v (Hkv heads), each read or written once."""
    _, hq, hkv, hd = _dims(a)
    nl = a["num_hidden_layers"] if layers is None else layers
    return float(n * (hq * hd * 2 + hkv * hd * 2) * elem * nl)


def bound_seconds(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the chip could take: the larger of the operations
    at the bf16 tensor-core rate and the bytes at the HBM rate."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes_s"])


def matmul_params(a: dict) -> int:
    """Non-embedding matmul parameters: q, k, v, o and the three MLP
    projections of every layer."""
    d, hq, hkv, hd = _dims(a)
    ff = a["intermediate_size"]
    per_layer = d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff
    return per_layer * a["num_hidden_layers"]


def head_flops(a: dict) -> float:
    """The LM head for one emitted token."""
    return 2.0 * a["hidden_size"] * a["vocab_size"]


def prefill_flops(a: dict, n: int) -> float:
    """Model operations a prefill of an n-token prompt needs: its matmuls
    for every prompt token, causal attention over the prompt, and the LM
    head for the one token it emits."""
    return 2.0 * matmul_params(a) * n + attention_flops(a, n) + head_flops(a)


def token_flops(a: dict, keys: int) -> float:
    """Model operations of one decoded token that attends over `keys`
    positions (its own included)."""
    _, hq, _, hd = _dims(a)
    attn = keys * 2 * (hd + hd) * hq * a["num_hidden_layers"]
    return 2.0 * matmul_params(a) + attn + head_flops(a)
