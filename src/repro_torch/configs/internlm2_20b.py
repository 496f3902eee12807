"""internlm2-20b [dense]: 48L d6144 48H GQA(kv=8) ff16384 v92544.
[arXiv:2403.17297; hf]"""
import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab=92544,
    rope_theta=1e6, microbatches=16, moment_dtype="int8",
    param_dtype=torch.bfloat16,
)

# The serving run the port is checked at on the card (chip_smoke.py phase
# 10).  Prefill: one prompt of the reference's `prefill_32k` length
# (`repro/models/config.py` SHAPES: seq 32768, global batch 32), the batch
# cut from 32 to 1 to fit one card beside the 39.7 GB of bf16 weights and
# the script's time limit.  Serve: the reference launcher's defaults
# (`repro/launch/serve.py`: --batch 4, --prompt-len 32, --tokens 16,
# --cache-len 128) through its paged engine.
SERVE_RUN = dict(prefill_len=32768, prefill_batch=1, batch=4, prompt_len=32,
                 new_tokens=16, cache_len=128)


def smoke():
    return ModelConfig(
        name="internlm2-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
        rope_theta=1e6, remat="none", microbatches=1)
