"""Where the serving engine's time goes on the card.

Builds the engine at full width (random seeded weights), then times and
traces with torch.profiler: (a) engine steps that only decode, all slots
busy, and (b) the first step of a fresh engine, which prefills one request
and decodes it once.  Prints, per phase, the host wall time per step
without the profiler, the device busy time per step (sum of the CUDA
kernels and copies the trace records), the number of device operations
per step, and the kernels that take the most device time.  Writes the
same as JSON to --out.

  python -m repro_torch.tools.profile_serve --out profile_serve.json
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch


def trace_steps(fn, n: int) -> dict:
    """Profile `n` calls of fn; device events summed by name."""
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


STEPS = 10


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="", help="write the report as JSON")
    args = ap.parse_args(argv)

    from ..configs import qwen2_0_5b as serving   # chip_smoke.py's run
    from ..serve.engine import ServeEngine

    cfg = serving.CONFIG
    engine_kw = dict(device="cuda", **serving.SERVE_ENGINE)
    slots = engine_kw["max_slots"]
    prompt_len = serving.SERVE_TRAFFIC["prompt_len"]
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(slots, prompt_len))
    max_new = engine_kw["max_seq"] - prompt_len

    eng = ServeEngine(cfg, init_seed=0, **engine_kw)
    for p in prompts:
        eng.submit(p, max_new)
    for _ in range(3):                       # admit every slot, warm up
        eng.step()
    decode = {"wall_ms_per_step": wall_ms(eng.step, STEPS),
              **trace_steps(eng.step, STEPS)}

    def first_step():
        e = ServeEngine(cfg, params=eng.params, **engine_kw)
        e.submit(prompts[0], 2)
        return e

    first_step().step()                      # warm up
    engines = [first_step() for _ in range(STEPS)]
    it = iter(engines)
    prefill_wall = wall_ms(lambda: next(it).step(), STEPS)
    engines = [first_step() for _ in range(3)]
    it = iter(engines)
    prefill = {"wall_ms_per_step": prefill_wall,
               **trace_steps(lambda: next(it).step(), 3)}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[profile] {cfg.name} on {card}")
    report = {"arch": cfg.name, "card": card, "slots": slots,
              "decode_step": decode, "prefill_plus_one_decode": prefill}
    for phase in ("decode_step", "prefill_plus_one_decode"):
        r = report[phase]
        idle = 1 - r["device_busy_ms_per_step"] / r["wall_ms_per_step"]
        r["device_idle_share"] = idle
        print(f"[profile] {phase}: wall {r['wall_ms_per_step']:.3f} ms/step, "
              f"device busy {r['device_busy_ms_per_step']:.3f} ms/step "
              f"(idle share {idle:.3f}), "
              f"{r['device_ops_per_step']:.0f} device ops/step")
        for name, ms in r["top_kernels_ms_per_step"]:
            print(f"    {ms:9.4f} ms  {name}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
