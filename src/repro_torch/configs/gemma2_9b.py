"""gemma2-9b [dense]: 42L d3584 16H GQA(kv=8) hd256 ff14336 v256000,
alternating local(4k SWA)/global attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense", n_layers=42, d_model=3584,
    n_heads=16, n_kv_heads=8, head_dim=256, d_ff=14336, vocab=256000,
    local_global_period=2, local_window=4096, softcap=50.0,
    final_softcap=30.0, microbatches=16, moment_dtype="bf16",
)

# The serving run the port is checked at on the card (chip_smoke.py phase
# 10).  Prefill: one prompt of the reference's `prefill_32k` length
# (`repro/models/config.py` SHAPES: seq 32768, global batch 32), the batch
# cut from 32 to 1 to fit one card beside the 40.6 GB of f32 weights and
# the script's time limit.  Serve: the reference launcher's defaults
# (`repro/launch/serve.py`: --batch 4, --prompt-len 32, --tokens 16,
# --cache-len 128) through its paged engine.  Long decode: one step
# against `decode_32k`'s cache length (seq 32768, global batch 128), the
# batch cut from 128 to 2 so that the 21 global caches (21 x 2 x 32768 x
# 8 heads x 256 x k and v x 2 B = 11.3 GB) and the 21 local rings of 4096
# slots fit one card beside the f32 weights.
SERVE_RUN = dict(prefill_len=32768, prefill_batch=1, batch=4, prompt_len=32,
                 new_tokens=16, cache_len=128, long_cache_len=32768,
                 long_batch=2)


def smoke():
    return ModelConfig(
        name="gemma2-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        local_global_period=2, local_window=16, softcap=50.0,
        final_softcap=30.0, remat="none", microbatches=1)
