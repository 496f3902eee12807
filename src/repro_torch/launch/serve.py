"""Serving launcher: the continuous-batching engine on the paged
symmetric-heap KV cache, on the CUDA card (or the CPU with --device cpu).

Submits --batch requests of random prompts up front and drains them.

  python -m repro_torch.launch.serve --arch qwen2-0.5b
  python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config instead of full size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16,
                    help="new tokens per request")
    ap.add_argument("--slots", type=int, default=0,
                    help="engine batch slots (default: --batch, max 8)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..configs import get_config, smoke_config
    from ..serve.engine import ServeEngine

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    slots = args.slots or min(args.batch, 8)
    max_seq = args.prompt_len + args.tokens
    bucket = -(-args.prompt_len // args.page_size) * args.page_size
    eng = ServeEngine(cfg, device=device, max_slots=slots,
                      page_size=args.page_size, max_seq=max_seq,
                      prompt_bucket=min(bucket, max_seq))
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(args.batch, args.prompt_len),
                           dtype=np.int32)
    t0 = time.perf_counter()
    rids = [eng.submit(p, args.tokens) for p in prompts]
    eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    gen = np.stack([eng.results[r] for r in rids])
    print(f"[serve] (paged, {device}) generated {gen.shape} in {dt:.2f}s "
          f"({gen.size / dt:.1f} tok/s, {eng.steps} engine steps, "
          f"page={args.page_size} slots={slots})")
    print(gen[:, :8])
    return gen


if __name__ == "__main__":
    main()
