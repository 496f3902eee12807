"""phi-3-vision-4.2b [vlm]: phi3-mini backbone 32L d3072 32H ff8192
v32064 + CLIP frontend (STUB: input_specs provides precomputed patch
embeddings scattered over the first 576 positions).
[hf:microsoft/Phi-3-vision-128k-instruct]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, head_dim=96, d_ff=8192, vocab=32064,
    frontend="vision", n_frontend_tokens=576, microbatches=8,
)

# The serving run the port is checked at on the card (chip_smoke.py phase
# 13).  Prefill: the reference's `prefill_32k` cell (`repro/models/
# config.py` SHAPES: seq 32768, global batch 32) with the batch cut from
# 32 to 1, its frontend embeds (1, 576, 3072) from `input_specs`, to fit
# one card beside the 14.2 GiB of f32 weights and the script's time
# limit.  Serve: the reference launcher's defaults (`repro/launch/
# serve.py`: --batch 4, --prompt-len 32, --tokens 16, --cache-len 128)
# through its paged engine, which takes prompts of tokens only.  Long
# decode: one step against `decode_32k`'s cache length (seq 32768,
# global batch 128), the batch cut from 128 to 2: one row's caches are
# 32 layers x k and v x 32768 x 32 heads x 96 x 2 B = 12.0 GiB, so batch
# 4 would not fit beside the f32 weights.
SERVE_RUN = dict(prefill_len=32768, prefill_batch=1, batch=4, prompt_len=32,
                 new_tokens=16, cache_len=128, long_cache_len=32768,
                 long_batch=2)


def smoke():
    return ModelConfig(
        name="phi3v-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=128,
        frontend="vision", n_frontend_tokens=8, remat="none",
        microbatches=1)
