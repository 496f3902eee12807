"""h2o-danube-3-4b [dense]: 24L d3840 32H GQA(kv=8) ff10240 v32000,
llama+mistral mix with sliding-window attention. [arXiv:2401.16818]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, head_dim=120, d_ff=10240, vocab=32000,
    window=4096, microbatches=8,
)

# The serving run the port is checked at on the card (chip_smoke.py phase
# 10).  Prefill: one prompt of the reference's `prefill_32k` length
# (`repro/models/config.py` SHAPES: seq 32768, global batch 32), the batch
# cut from 32 to 1 to fit one card and the script's time limit.  Serve:
# the reference launcher's defaults (`repro/launch/serve.py`: --batch 4,
# --prompt-len 32, --tokens 16, --cache-len 128) through its paged engine.
SERVE_RUN = dict(prefill_len=32768, prefill_batch=1, batch=4, prompt_len=32,
                 new_tokens=16, cache_len=128)


def smoke():
    return ModelConfig(
        name="danube-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
        window=16, remat="none", microbatches=1)
