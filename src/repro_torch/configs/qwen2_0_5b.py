"""qwen2-0.5b [dense]: 24L d896 14H GQA(kv=2) ff4864 v151936, QKV bias,
tied embeddings. [arXiv:2407.10671; hf]"""
from ..models.config import ModelConfig
from . import epiphany16

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, head_dim=64, d_ff=4864, vocab=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6, microbatches=4,
)

# The serving run the port is checked at on the card (chip_smoke.py): the
# engine's settings and the traffic.  Where a served step's time goes is
# read by the benchmark's traced run, `python3 ptbench/run.py --workload
# <cell> --seed <n> --seconds 51 --trace 1`.
SERVE_ENGINE = dict(max_slots=4, page_size=16, max_seq=256, prompt_bucket=128)
SERVE_TRAFFIC = dict(requests=8, prompt_len=100, new_tokens=32)

# The training run the port is checked at on the card (chip_smoke.py):
# the reference launcher's defaults (`repro/launch/train.py`: --seq-len
# 128, --batch 8, --lr 3e-4) and the steps of each gradient sync.
TRAIN_RUN = dict(seq_len=128, batch=8, lr=3e-4, steps=12)

# The sequence-sharded ring-attention run the port is checked at on the
# card (chip_smoke.py phase 8): the q, k and v of layer `layer` over one
# prompt of the reference's `prefill_32k` length (`repro/models/config.py`
# SHAPES: seq 32768, global batch 32, the batch cut to 1 for one card and
# the script's time limit), sharded over the paper's 16 PEs on the 4x4
# eMesh (`configs/epiphany16.py`: 2048 tokens a PE).
RING_RUN = dict(seq_len=32768, batch=1, n_pes=epiphany16.N_PES,
                topology=epiphany16.TOPOLOGY, layer=0)


def smoke():
    return ModelConfig(
        name="qwen2-smoke", family="dense", n_layers=2, d_model=48,
        n_heads=3, n_kv_heads=1, head_dim=16, d_ff=96, vocab=128,
        qkv_bias=True, tie_embeddings=True, remat="none", microbatches=1)
