"""Serving launcher: the continuous-batching engine on the paged
symmetric-heap KV cache, on the CUDA card (or the CPU with --device cpu).

Submits --batch requests of random prompts up front and drains them
through an engine sized, as the reference's, for sequences of
max(--cache-len, --prompt-len + --tokens) tokens (the dense and vlm
families; the engine takes prompts of tokens only, as the reference's).
Families without a paged path (ssm, hybrid, moe) take the reference's
dense-cache decode loop instead: the prompt fed teacher-forced through
`decode_step` against caches of --cache-len slots, then --tokens greedy
tokens.  An encoder-only arch (hubert-xlarge) has no decode loop: the
launcher exits for it, as the reference's does, before any work.

  python -m repro_torch.launch.serve --arch qwen2-0.5b
  python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke --device cpu
  python -m repro_torch.launch.serve --arch gemma2-9b
  python -m repro_torch.launch.serve --arch gemma2-9b --smoke --device cpu
  python -m repro_torch.launch.serve --arch h2o-danube-3-4b
  python -m repro_torch.launch.serve --arch internlm2-20b
  python -m repro_torch.launch.serve --arch mamba2-2.7b
  python -m repro_torch.launch.serve --arch mamba2-2.7b --smoke --device cpu
  python -m repro_torch.launch.serve --arch zamba2-1.2b
  python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke --device cpu
  python -m repro_torch.launch.serve --arch granite-moe-3b-a800m
  python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --smoke --device cpu
  python -m repro_torch.launch.serve --arch deepseek-v3-671b --smoke --device cpu
  python -m repro_torch.launch.serve --arch phi-3-vision-4.2b
  python -m repro_torch.launch.serve --arch phi-3-vision-4.2b --smoke --device cpu

deepseek-v3-671b at full size (671 B parameters) does not fit one card;
`chip_smoke.py` serves it cut to its `SERVE_RUN["n_layers"]` layers
through `_decode_loop`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _decode_loop(cfg, device, args):
    """The reference's `_legacy_decode_loop`: seeded weights, dense decode
    caches of --cache-len slots, --prompt-len prompt tokens fed one step
    at a time, then --tokens greedy tokens.  Returns the (batch, tokens)
    generated ids."""
    from ..models import transformer
    from ..serve import step as sstep

    B = args.batch
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab, size=(B, args.prompt_len),
                          dtype=np.int32)
    params = transformer.init_params(cfg, seed=0, device=device)
    cache = transformer.init_cache(cfg, 1, B, args.cache_len, device=device)
    decode = sstep.build_decode_step(cfg)
    prompt_d = torch.as_tensor(prompt, device=device).long()
    t0 = time.perf_counter()
    tok = prompt_d[:, :1]
    out_tokens = []
    for t in range(args.prompt_len + args.tokens - 1):
        batch = {"tokens": tok,
                 "positions": torch.full((B,), t, device=device)}
        logits, cache = decode(params, cache, batch)
        nxt = logits[:, 0].argmax(-1)
        if t + 1 < args.prompt_len:
            tok = prompt_d[:, t + 1:t + 2]
        else:
            tok = nxt[:, None]
            out_tokens.append(nxt)
    gen = torch.stack(out_tokens, 1).cpu().numpy().astype(np.int32)
    dt = time.perf_counter() - t0
    print(f"[serve] (dense loop, {device}) generated {gen.shape} in "
          f"{dt:.2f}s ({B * gen.shape[1] / dt:.1f} tok/s)")
    return gen


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
    ap.add_argument("--cache-len", type=int, default=128,
                    help="attention cache length (the paged engine's "
                         "max_seq is at least this)")
    ap.add_argument("--slots", type=int, default=0,
                    help="engine batch slots (default: --batch, max 8)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..configs import get_config, smoke_config
    from ..models import transformer
    from ..serve.engine import ServeEngine

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode loop")
    device = resolve_device(args.device)
    if cfg.family not in transformer.paged_families():
        if cfg.family != "ssm" and cfg.window is None \
                and args.prompt_len + args.tokens - 1 > args.cache_len:
            ap.error(f"--cache-len {args.cache_len} holds fewer than the "
                     f"{args.prompt_len + args.tokens - 1} positions the "
                     f"loop decodes")
        return _decode_loop(cfg, device, args)
    slots = args.slots or min(args.batch, 8)
    max_seq = max(args.cache_len, args.prompt_len + args.tokens)
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
