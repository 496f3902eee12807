"""End-to-end run on the PyTorch port: train a ~100M-param GQA model
for a few hundred steps with checkpoint/restart, on the shmem substrate.

The config is registered with the port's arch registry as the reference
registers it, then trained through the train launcher
(`repro_torch.launch.train`), checkpointing every --ckpt-every steps and
resuming from the latest checkpoint in --ckpt-dir.  --smoke trains a cut
of it (2 layers, d_model 64) for a quick check.

Runs on the CUDA card unless given --device cpu.

Run:  PYTHONPATH=src python examples/pt_train_100m.py [--steps 300]
          [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.configs.registry as registry  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

# ~100M params: 12L, d=768, 12H/4kv, ff 2048, 32k vocab
CFG_100M = ModelConfig(
    name="gqa-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32000,
    remat="none", microbatches=1)

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "experiments",
                        "pt_train_100m")


def register():
    """Register the config as arch "gqa-100m" (its smoke() a 2-layer cut
    at d_model 64)."""
    mod = type(sys)("repro_torch.configs._tmp100m")
    mod.CONFIG = CFG_100M
    mod.smoke = lambda: dataclasses.replace(
        CFG_100M, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=512)
    sys.modules["repro_torch.configs._tmp100m"] = mod
    registry.ARCHS["gqa-100m"] = "_tmp100m"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    register()
    return train_mod.main([
        "--arch", "gqa-100m", "--steps", str(args.steps),
        "--data", "1", "--model", "1", "--seq-len", str(args.seq_len),
        "--batch", str(args.batch), "--ckpt-dir", args.ckpt_dir,
        "--resume", "auto", "--ckpt-every", str(args.ckpt_every)]
        + (["--smoke"] if args.smoke else [])
        + ([] if args.device is None else ["--device", args.device]))


if __name__ == "__main__":
    main()
