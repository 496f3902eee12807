"""Where a full-width prefill's and long decode step's time goes on the card.

For an architecture whose config module has a `SERVE_RUN` (the run
`chip_smoke.py` checks), builds the model at full width with seeded
random weights (at SERVE_RUN's `n_layers` where it cuts the depth, as
deepseek-v3's does to 4 of its 61 layers), then prints the host wall of
three `build_prefill` calls over SERVE_RUN's prompt (`prefill_inputs`:
the `prefill_32k` cell's inputs at SERVE_RUN's batch, hubert-xlarge's
frames and phi-3-vision's frontend embeds among them; the first call
carries one-time start-up) and, from
torch.profiler over one more, the device busy time, the idle share
against the last wall, the device operations and the kernels that take
the most device time.  Where SERVE_RUN has a long decode (`long_batch`
rows against `long_cache_len` slots), the same for one
`build_decode_step` at the last position.  Writes the report as JSON to
--out.

  python -m repro_torch.tools.profile_prefill --arch gemma2-9b --out p.json
  python -m repro_torch.tools.profile_prefill --arch deepseek-v3-671b
  python -m repro_torch.tools.profile_prefill --arch hubert-xlarge
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib
import json
import subprocess
import time

import numpy as np
import torch


def trace_steps(fn, n: int) -> dict:
    """Profile `n` calls of fn; device events summed by name (a sum, not
    the union of overlapping events)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            count += 1
    busy_us = sum(by_name.values())
    return {"device_busy_ms_per_step": busy_us / n / 1e3,
            "device_ops_per_step": count / n,
            "top_kernels_ms_per_step": [
                (name[:90], us / n / 1e3)
                for name, us in by_name.most_common(12)]}


def wall_ms(fn, n: int) -> float:
    """Host wall of `n` calls of fn, from one device wait to another."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _phase(fn, label: str) -> dict:
    walls = [wall_ms(fn, 1) for _ in range(3)]
    r = {"wall_ms": walls, **trace_steps(fn, 1)}
    r["device_idle_share"] = 1 - r["device_busy_ms_per_step"] / walls[-1]
    print(f"[profile] {label}: wall {', '.join(f'{w:.3f}' for w in walls)} "
          f"ms, device busy {r['device_busy_ms_per_step']:.3f} ms (idle "
          f"share {r['device_idle_share']:.3f}), "
          f"{r['device_ops_per_step']:.0f} device ops")
    for name, ms in r["top_kernels_ms_per_step"]:
        print(f"    {ms:9.4f} ms  {name}")
    return r


def prefill_inputs(cfg, run: dict, device) -> dict:
    """build_prefill's batch for SERVE_RUN `run`: every input of the
    `prefill_32k` cell (`models.config.input_specs`) at run's batch, token
    ids from a numpy generator seeded 0, frames and frontend embeds drawn
    unit-normal from a torch generator seeded 0 on `device`, in their
    specs' dtype."""
    from ..models.config import input_specs
    specs = input_specs(cfg, "prefill_32k",
                        batch_override=run["prefill_batch"])
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for name, spec in specs.items():
        shape = tuple(spec.shape)
        if spec.dtype == torch.int32:                # token ids
            out[name] = torch.as_tensor(np.random.default_rng(0).integers(
                1, cfg.vocab, size=shape), device=device)
        else:
            out[name] = torch.randn(shape, generator=gen,
                                    device=device).to(spec.dtype)
    return out


def main(argv=None):
    from ..configs import ARCHS
    from ..models import transformer
    from ..serve import step as sstep

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--out", default="", help="write the report as JSON")
    args = ap.parse_args(argv)
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[args.arch]}")
    if not hasattr(mod, "SERVE_RUN"):
        ap.error(f"{args.arch}'s config has no SERVE_RUN")
    cfg, run = mod.CONFIG, mod.SERVE_RUN
    if "n_layers" in run:
        cfg = dataclasses.replace(cfg, n_layers=run["n_layers"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[profile] {cfg.name} ({cfg.n_layers} layers) on {card}")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    batch = prefill_inputs(cfg, run, "cuda")
    prefill = sstep.build_prefill(cfg)
    report = {"arch": cfg.name, "card": card, "prefill": _phase(
        lambda: prefill(params, batch),
        f"prefill, batch {run['prefill_batch']} x L {run['prefill_len']} "
        f"({', '.join(batch)})")}
    del batch
    if "long_cache_len" in run:
        B, S = run["long_batch"], run["long_cache_len"]
        cache = transformer.init_cache(cfg, 1, B, S, device="cuda")
        decode = sstep.build_decode_step(cfg)
        batch = {"tokens": torch.ones((B, 1), dtype=torch.long,
                                      device="cuda"),
                 "positions": torch.full((B,), S - 1, device="cuda")}
        report["decode_step"] = _phase(
            lambda: decode(params, cache, batch),
            f"decode step, batch {B} against {S} slots")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
