"""The readings the comparison's limits are set from, on the card.

  python3 ptbench/calibrate.py --workload <cell> --seconds <s> --seeds 1,2,3

runs the cell as `run.py` does, seed after seed in one process, and
judges on each seed's sample both the program and the control: the
plain reference computed in float8 put in the program's place (the
family's `logits(..., fp8=True)`), through the same comparison
(`judge.passed`) at the cell's limit.  Prints one JSON line a seed:
each side's widest gap and whether it came out correct.  The benchmark's
own runs never run the control."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from ptbench import judge, run
    run.fixed_caches(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = run.execute(args.workload, seed, args.seconds, False,
                          control=True)
        c, cc = out["checks"], out["control_checks"]
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "widest_gap": c["widest_gap"]["value"],
                          "control_correct": judge.passed(cc),
                          "control_widest_gap": cc["widest_gap"]["value"],
                          "limit": c["widest_gap"]["limit"],
                          "tokens": c["tokens_checked"]["value"],
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "memory_peak_bytes":
                              out["device"]["memory_peak_bytes"],
                          "wall_s": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
