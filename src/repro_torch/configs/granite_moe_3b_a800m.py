"""granite-moe-3b-a800m [moe]: 32L d1536 24H GQA(kv=8) 40 experts top-8
(expert ff 512), v49155. [hf:ibm-granite]"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, head_dim=64, d_ff=512, vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512), microbatches=2,
)

# The serving run the port is checked at on the card (chip_smoke.py phase
# 11).  Prefill: one prompt of the reference's `prefill_32k` length
# (`repro/models/config.py` SHAPES: seq 32768, global batch 32), the batch
# cut from 32 to 1 to fit one card beside the 12.57 GiB of f32 weights and
# the script's time limit.  Decode: the reference launcher's defaults
# (`repro/launch/serve.py`: --batch 4, --prompt-len 32, --tokens 16,
# --cache-len 128) through its dense-cache decode loop (the moe family is
# not paged).
SERVE_RUN = dict(prefill_len=32768, prefill_batch=1, batch=4, prompt_len=32,
                 new_tokens=16, cache_len=128)


def smoke():
    return ModelConfig(
        name="granite-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64, vocab=128,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64),
        remat="none", microbatches=1)
