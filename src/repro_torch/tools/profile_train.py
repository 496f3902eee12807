"""Where a training step's time goes on the card.

Trains qwen2-0.5b at full width (random seeded weights) with the run
`chip_smoke.py` checks (`configs/qwen2_0_5b.py` TRAIN_RUN: seq 128,
batch 8, 4 microbatches, remat full), once with the default gradient
sync (apply_updates) and once with the fused sync (kernel 5).  After two
warm-up steps it prints, per sync, the host wall time per step without
the profiler, the device busy time per step (the CUDA kernels and copies
torch.profiler records), the device idle share, the device operations
per step and the kernels that take the most device time.  Writes the
same as JSON to --out.

  python -m repro_torch.tools.profile_train --out profile_train.json
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from .profile_prefill import trace_steps, wall_ms

STEPS = 3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="write the report as JSON")
    args = ap.parse_args(argv)

    from ..configs import qwen2_0_5b as qwen
    from ..data.pipeline import SyntheticLM
    from ..models import transformer
    from ..train import optimizer as opt
    from ..train import step as tstep

    cfg, run = qwen.CONFIG, qwen.TRAIN_RUN
    pipe = SyntheticLM(cfg.vocab, run["seq_len"], run["batch"])
    adamw = opt.AdamWConfig(lr=run["lr"], moment_dtype=cfg.moment_dtype)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    report = {"arch": cfg.name, "card": card, "train_run": run}
    for sync in ("default", "fused"):
        params = transformer.init_params(cfg, seed=0, device="cuda")
        if sync == "fused":
            state = tstep.init_fused_opt_state(params)
            step = tstep.build_train_step(cfg, adamw=adamw, grad_rs="fused")
        else:
            state = opt.init_state(params, adamw)
            step = tstep.build_train_step(cfg, adamw=adamw)
        box = {"params": params, "state": state, "i": 0}

        def one():
            loss, box["params"], box["state"] = step(
                box["params"], box["state"], pipe.batch(box["i"]))
            box["i"] += 1
            return loss

        for _ in range(2):                   # warm up
            float(one())
        r = {"wall_ms_per_step": wall_ms(one, STEPS),
             **trace_steps(one, STEPS)}
        r["device_idle_share"] = (1 - r["device_busy_ms_per_step"]
                                  / r["wall_ms_per_step"])
        report[sync] = r
        print(f"[profile] {cfg.name} train step, {sync} sync, on {card}: "
              f"wall {r['wall_ms_per_step']:.3f} ms/step, device busy "
              f"{r['device_busy_ms_per_step']:.3f} ms/step (idle share "
              f"{r['device_idle_share']:.3f}), "
              f"{r['device_ops_per_step']:.0f} device ops/step")
        for name, ms in r["top_kernels_ms_per_step"]:
            print(f"    {ms:9.4f} ms  {name}")
        del box, params, state
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
