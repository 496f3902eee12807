"""deepseek-v3-671b [moe]: 61L d7168 128H MLA, 1 shared + 256 routed
top-8 experts (ff 2048), first 3 layers dense (ff 18432), MTP head,
v129280.  EP over the full (data x model) mesh, ZeRO-3 fsdp for the
dense trunk, int8 optimizer moments. [arXiv:2412.19437; hf]"""
import torch

from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, head_dim=128, d_ff=18432, vocab=129280,
    attn="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1,
                  first_dense_layers=3, ep_over_data=True),
    mtp=True, fsdp=True, moment_dtype="int8", microbatches=16,
    param_dtype=torch.bfloat16,   # 1.3 TB of experts: bf16 storage, f32
                                  # optimizer math (deepseek itself used fp8)
)

# The serving run the port is checked at on the card (chip_smoke.py phase
# 11), on CONFIG with n_layers cut from 61 to 4: 671 B parameters do not
# fit one card, and 4 layers are its 3 dense MLA layers and its first MoE
# layer (all 256 routed experts and the shared one), every kind of layer
# the model has at its published width: 15,111,086,080 parameters, 28.15
# GiB of bf16 weights, plus the MTP block.  Prefill: one prompt of the
# reference's `prefill_32k` length (`repro/models/config.py` SHAPES: seq
# 32768, global batch 32), the batch cut from 32 to 1.  Decode: the
# reference launcher's defaults (`repro/launch/serve.py`: --batch 4,
# --prompt-len 32, --tokens 16, --cache-len 128) through its dense-cache
# decode loop (the moe family is not paged).  Long decode: one step against
# `decode_32k`'s cache length (seq 32768, global batch 128), the batch cut
# from 128 to 4.
SERVE_RUN = dict(n_layers=4, prefill_len=32768, prefill_batch=1, batch=4,
                 prompt_len=32, new_tokens=16, cache_len=128,
                 long_cache_len=32768, long_batch=4)


def smoke():
    return ModelConfig(
        name="deepseek-smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=160, vocab=128,
        attn="mla",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                      qk_rope_dim=8, v_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                      first_dense_layers=1),
        mtp=True, remat="none", microbatches=1)
