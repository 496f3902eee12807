"""zamba2-1.2b [hybrid]: 38 Mamba2 layers (d2048, state 64) with a shared
attention(32H)+MLP block applied every 6 layers, v32000.
[arXiv:2411.15242; hf]"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, vocab=32000,
    ssm=SSMConfig(state=64, head_dim=64, n_groups=1, expand=2),
    hybrid_attn_period=6, microbatches=8,
)

# The serving run the port is checked at on the card (chip_smoke.py phase
# 9).  Prefill: one prompt of the reference's `prefill_32k` length
# (`repro/models/config.py` SHAPES: seq 32768, global batch 32), the batch
# cut from 32 to 1 to fit one card and the script's time limit.  Decode:
# the reference launcher's defaults (`repro/launch/serve.py`: --batch 4,
# --prompt-len 32, --tokens 16, --cache-len 128) through its dense-cache
# decode loop.  Long decode: one step against `decode_32k`'s cache length
# (seq 32768, global batch 128), the batch cut from 128 to 4 so that the 7
# shared attention caches (7 x 4 x 32768 x 32 heads x 64 x k and v x 2 B =
# 7.5 GB) fit one card beside the f32 weights.
SERVE_RUN = dict(prefill_len=32768, prefill_batch=1, batch=4, prompt_len=32,
                 new_tokens=16, cache_len=128, long_cache_len=32768,
                 long_batch=4)


def smoke():
    return ModelConfig(
        name="zamba2-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=128,
        ssm=SSMConfig(state=8, head_dim=8, n_groups=1, expand=2, chunk=8,
                      conv_width=4),
        hybrid_attn_period=2, remat="none", microbatches=1)
