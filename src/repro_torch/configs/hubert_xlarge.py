"""hubert-xlarge [audio]: encoder-only 48L d1280 16H ff5120, masked-unit
prediction over 504 clusters; conv feature extractor STUBBED (input_specs
provides frame embeddings). [arXiv:2106.07447]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, head_dim=80, d_ff=5120, vocab=504,
    causal=False, frontend="audio", microbatches=4,
)

# The serving run the port is checked at on the card (chip_smoke.py phase
# 12).  Prefill: the reference's `prefill_32k` cell (`repro/models/
# config.py` SHAPES: seq 32768, global batch 32) with the batch cut from
# 32 to 1, so frames (1, 32768, 1280) from `input_specs`, to fit the
# script's time limit beside the other phases.  No launcher run and no
# decode: an encoder has no decode step (`shape_applicable`), and the
# reference's serve launcher exits for it.
SERVE_RUN = dict(prefill_len=32768, prefill_batch=1)


def smoke():
    return ModelConfig(
        name="hubert-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=32,
        causal=False, frontend="audio", remat="none", microbatches=1)
