"""mamba2-2.7b [ssm]: 64L d2560, attention-free SSD (state 128,
head_dim 64), v50280. [arXiv:2405.21060]"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv_heads=0, head_dim=None, d_ff=0, vocab=50280,
    attn="none",
    ssm=SSMConfig(state=128, head_dim=64, n_groups=1, expand=2),
    microbatches=8,
)

# The serving run the port is checked at on the card (chip_smoke.py phase
# 7).  Prefill: one prompt of the reference's `prefill_32k` length
# (`repro/models/config.py` SHAPES: seq 32768, global batch 32), the batch
# cut from 32 to 1 to fit one card and the script's time limit.  Decode:
# the reference launcher's defaults (`repro/launch/serve.py`: --batch 4,
# --prompt-len 32, --tokens 16) through its dense-cache decode loop.
SERVE_RUN = dict(prefill_len=32768, prefill_batch=1, batch=4, prompt_len=32,
                 new_tokens=16)


def smoke():
    return ModelConfig(
        name="mamba2-smoke", family="ssm", n_layers=3, d_model=64,
        n_heads=0, n_kv_heads=0, head_dim=None, d_ff=0, vocab=128,
        attn="none",
        ssm=SSMConfig(state=8, head_dim=8, n_groups=1, expand=2, chunk=8),
        remat="none", microbatches=1)
