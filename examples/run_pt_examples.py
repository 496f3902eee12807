"""Run each of the port's examples (`examples/pt_*.py`) to its end, one
process each as a user would start it, and print its wall and exit code;
the examples' own output goes to a log file each.

Run from the root of a checkout:
  python3 examples/run_pt_examples.py [--device cpu] [--out DIR]
Each example runs on the CUDA card unless --device cpu is given.  Writes
DIR/<example>.log and DIR/walls.json ({example: {"wall_s", "rc"}}); exits
non-zero if any example failed.  pt_train_100m starts from no checkpoint
and checkpoints under build/ (a checkpoint of its ~100M parameters and
moments is over a GB), removed after.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
EXAMPLES = ("pt_quickstart", "pt_collectives_showcase",
            "pt_hierarchical_allreduce", "pt_serve_batched",
            "pt_trace_serve", "pt_train_100m")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=str(HERE.parent / "build"
                                         / "pt_examples"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               BENCH_OUT_DIR=str(out / "bench-reports"))
    ckpt = HERE.parent / "build" / "pt_train_100m"
    shutil.rmtree(ckpt, ignore_errors=True)
    extra = {"pt_train_100m": ["--ckpt-dir", str(ckpt)]}
    walls = {}
    for name in EXAMPLES:
        cmd = [sys.executable, str(HERE / f"{name}.py")] \
            + ([] if args.device is None else ["--device", args.device]) \
            + extra.get(name, [])
        t0 = time.perf_counter()
        with open(out / f"{name}.log", "w") as log:
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=env).returncode
        walls[name] = {"wall_s": time.perf_counter() - t0, "rc": rc}
        print(f"{name}: {walls[name]['wall_s']:.2f} s, exit {rc}",
              flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    (out / "walls.json").write_text(json.dumps(walls, indent=2))
    return 0 if all(w["rc"] == 0 for w in walls.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
