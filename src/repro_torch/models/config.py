"""ModelConfig — the architecture description shared by every module,
and the assigned input shapes (`SHAPES`, `shape_applicable`,
`input_specs`).

Counterpart of `repro/models/config.py` with torch dtypes.  The fields
are those the model code, the parameter count and the one-device trainer
read (remat, microbatches, moment_dtype) and the JAX package's sharding
switches (attention="ring", fsdp, shard_strategy).  `input_specs` gives tensors on the "meta" device, which
hold a shape and a dtype and allocate nothing: the port's stand-in for
`jax.ShapeDtypeStruct`.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                  # per-expert hidden
    n_shared: int = 0          # shared (always-on) experts
    first_dense_layers: int = 0
    router_noise: float = 0.0
    capacity_factor: float = 1.25
    ep_over_data: bool = False


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 128           # N
    head_dim: int = 64         # P
    n_groups: int = 1          # G (B/C groups)
    chunk: int = 128
    conv_width: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    # attention flavor
    attn: str = "gqa"           # gqa | mla | none
    qkv_bias: bool = False
    causal: bool = True
    window: int | None = None            # sliding window (all layers)
    local_global_period: int | None = None  # gemma2: odd layers local SWA
    local_window: int | None = None
    softcap: float | None = None          # attention logit softcap
    final_softcap: float | None = None    # lm-head logit softcap
    rope_theta: float = 10000.0
    mla: MLAConfig | None = None
    # MoE / SSM / hybrid
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid_attn_period: int | None = None
    # heads
    tie_embeddings: bool = False
    mtp: bool = False
    # frontend stub
    frontend: str | None = None  # vision | audio
    n_frontend_tokens: int = 0
    # execution
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # stored weights
    logit_dtype: torch.dtype = torch.float32
    remat: str = "full"          # none | full | selective: recompute each
                                 # layer in the backward pass
                                 # (torch.utils.checkpoint; selective keeps
                                 # its weight products' outputs)
    microbatches: int = 1        # grad-accumulation steps per train step
    moment_dtype: str = "f32"    # f32 | bf16 | int8 (optimizer moments)
    # sharding (the reference's fields, same defaults)
    attention: str = "mono"      # mono | ring: "ring" runs sequence-sharded
                                 # attention over `data` (layers.attention)
    fsdp: bool = False           # ZeRO-3: 2D block weights sharded over
                                 # data (parallel/sharding.py)
    shard_strategy: str = "tp"   # tp | dp_only (replicate params, shard
                                 # the batch over data x model)

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    def param_count(self, active_only: bool = False) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd if self.attn != "none" else 0
        n_q, n_kv = self.n_heads, self.n_kv_heads
        per_layer = 0
        if self.attn == "gqa":
            per_layer += d * hd * (n_q + 2 * n_kv) + n_q * hd * d
            if self.qkv_bias:
                per_layer += hd * (n_q + 2 * n_kv)
        elif self.attn == "mla":
            m = self.mla
            per_layer += d * m.q_lora_rank
            per_layer += m.q_lora_rank * n_q * (m.qk_nope_dim + m.qk_rope_dim)
            per_layer += d * (m.kv_lora_rank + m.qk_rope_dim)
            per_layer += m.kv_lora_rank * n_q * (m.qk_nope_dim + m.v_dim)
            per_layer += n_q * m.v_dim * d
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            per_layer_ssm = d * (2 * d_in + 2 * s.n_groups * s.state + nheads)
            per_layer_ssm += d_in * d + nheads
            per_layer_ssm += s.conv_width * (d_in + 2 * s.n_groups * s.state)
        if self.moe is not None:
            mo = self.moe
            dense_ff = 3 * d * ff
            routed = 3 * d * mo.d_ff
            active_mlp = (mo.top_k + mo.n_shared) * routed + d * mo.n_experts
            total_mlp = (mo.n_experts + mo.n_shared) * routed + d * mo.n_experts
            mlp = active_mlp if active_only else total_mlp
        else:
            mlp = 3 * d * ff
            dense_ff = mlp

        total = 0
        for i in range(self.n_layers):
            if self.family in ("ssm", "hybrid"):
                total += per_layer_ssm + 2 * d
                continue
            total += per_layer + 2 * d
            if self.moe is not None and i < self.moe.first_dense_layers:
                total += dense_ff
            elif self.d_ff > 0:
                total += mlp
        if self.hybrid_attn_period:
            total += per_layer + 3 * d * self.d_ff + 2 * d
        total += v * d * (1 if self.tie_embeddings else 2)
        return int(total)


# ---------------------------------------------------------------------------
# input shapes (assigned): each cell is (name, seq_len, global_batch, kind)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k eligibility: sub-quadratic state only
LONG_OK_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(whether `cfg` runs the shape cell, why not)."""
    s = SHAPES[shape]
    if s["kind"] == "decode" and cfg.is_encoder:
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k":
        if cfg.family in LONG_OK_FAMILIES:
            return True, ""
        if cfg.window is not None or cfg.local_global_period is not None:
            return True, ""  # SWA-bounded KV
        return False, "pure full-attention arch skipped for 500k decode"
    return True, ""


def input_specs(cfg: ModelConfig, shape: str, *, batch_override=None):
    """Every model input of a shape cell as a tensor on the "meta" device
    (a shape and a dtype, no storage): token ids int32, frames and
    frontend embeds in cfg.dtype, as the reference's ShapeDtypeStructs."""
    s = SHAPES[shape]
    B = batch_override or s["global_batch"]
    L = s["seq_len"]

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    i32 = torch.int32
    if s["kind"] == "decode":
        # one new token against a cache of length L
        return dict(tokens=spec((B, 1), i32), positions=spec((B,), i32))
    train = s["kind"] == "train"
    if cfg.frontend == "audio":
        # encoder: the stub frontend provides frame embeddings
        specs = dict(frames=spec((B, L, cfg.d_model), cfg.dtype))
        if train:
            specs["targets"] = spec((B, L), i32)
        return specs
    specs = dict(tokens=spec((B, L), i32))
    if train:
        specs["targets"] = spec((B, L), i32)
    if cfg.frontend == "vision":
        specs["frontend_embeds"] = spec(
            (B, cfg.n_frontend_tokens, cfg.d_model), cfg.dtype)
    return specs
