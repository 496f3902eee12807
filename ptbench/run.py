"""One run of one cell of the port's benchmark.

  python3 ptbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Builds the cell's weights from the seed on the card, drives the
cell's traffic through the port for `--seconds` after a warm-up, checks
the served tokens against the plain reference, and prints as its last
line one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1), `device` (and `breakdown` with --trace 1), and last
`checks`, each number compared beside its limit (also the last lines of
standard error).  Exits non-zero, printing no result, without CUDA or
with fewer cards than the cell asks for, or if `jax`, `jaxlib`, `flax`
or the JAX package `repro` is loaded when the window closes.  Build and
kernel caches stay in `build/` of the checkout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started, from its start time in /proc,
    so that the interpreter's own start counts."""
    stat = Path("/proc/self/stat").read_text()
    start = int(stat.rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start / os.sysconf("SC_CLK_TCK"))


def fixed_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc builds already go to build/repro_torch/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(root / "build" / sub)
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Job:
    cell: dict
    arch: dict
    cfg: object
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    device_name: str
    ref: object             # ref/<family>.py of the configuration
    counts: object          # counts/<family>.py
    weights: dict
    setup_clock: object


class Refused(RuntimeError):
    """The run must not print a result."""


def execute(cell_name: str, seed: int, seconds: float, trace: bool, *,
            device="cuda", arch=None, cfg=None, mix=None, limit=None,
            setup_clock=process_age, bench=None, control=False) -> dict:
    """Run a cell and return its result object.  Tests pass `device="cpu"`
    and a small `arch`, `cfg` and `mix`; the run is otherwise the same.
    `control` also judges the control in the program's place
    (`calibrate.py`), under `control_checks`."""
    import torch
    from ptbench import judge, spec, traffic

    bench = bench or spec.benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    arch = arch or spec.config(cell["config"])
    cfg = cfg or spec.program_config(arch)
    mix = mix or traffic.load_mix(cell["traffic"])
    limit = spec.limits(cell_name)["widest_gap"]["limit"] \
        if limit is None else limit
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    ref, counts = spec.family(arch)
    job = Job(cell, arch, cfg, mix, seed, seconds, trace, device, name,
              ref, counts, ref.make_weights(arch, seed, device), setup_clock)
    win = spec.module("loads", mix["load"]).run(job)
    found = loaded_forbidden()
    if found:
        raise Refused(f"loaded when the window closed: {', '.join(found)}")

    print(f"ptbench: window {json.dumps(describe(win))}", file=sys.stderr)
    sides = judge.judge(ref, job.weights, arch, win.finished(),
                        int(mix["check_requests"]), seed, device, limit,
                        sides=("program", "control") if control
                        else ("program",))
    checks = sides["program"]
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if cell_name in m.get("workloads", [cell_name]):
                v = spec.module("metrics", m["name"]).read(win, job)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if cell_name not in m.get("workloads", [cell_name]):
                continue
            v = win.setup_s if m["name"] == "setup_s" else \
                spec.module("e2e", m["name"]).read(win, job)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": name, "count": int(cell["chips"]),
           "memory_peak_bytes": int(win.memory_peak_bytes)}
    out = {"correct": judge.passed(checks) and not win.failed,
           "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": dev}
    if trace and win.trace:
        dev["busy_s"] = win.trace["busy_s"]
        dev["window_s"] = win.trace["window_s"]
        out["breakdown"] = {"device_ops": win.trace["device_ops"],
                            "idle_gaps": win.trace["idle_gaps"]}
    if control:
        out["control_checks"] = sides["control"]
    out["checks"] = checks
    return out


def describe(win) -> dict:
    """What the window held, for the log: percentiles of the token gaps
    and of the first tokens' waits (the samples that `itl_p95_ms` and
    `ttft_mean_ms` read), and the steps' walls by the number of prefills
    they held."""
    from ptbench import stats
    gaps, ttft = win.token_gaps(), win.first_token_waits()
    by_prefills: dict = {}
    for st in win.steps:
        if stats.in_window(st.t_end, win.t0, win.t1):
            by_prefills.setdefault(len(st.admitted), []).append(
                st.t_end - st.t_start)
    ms = lambda xs, q: round(1e3 * stats.percentile(xs, q), 3) if xs \
        else None
    return {"itl_ms": {q: ms(gaps, q) for q in (50, 90, 95, 99)},
            "ttft_ms": {q: ms(ttft, q) for q in (50, 60, 90, 95)},
            "ttft_mean_ms": round(1e3 * sum(ttft) / len(ttft), 3)
            if ttft else None,
            "finished": len(win.finished()),
            "step_ms_by_prefills": {k: [len(v), ms(v, 50), ms(v, 90)]
                                    for k, v in sorted(by_prefills.items())}}


def card_line() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches(ROOT)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from ptbench import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("ptbench: no CUDA device; a run needs the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"ptbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        out = execute(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    except Refused as exc:
        print(f"ptbench: {exc}", file=sys.stderr)
        return 3
    print(f"ptbench: card {card_line()}", file=sys.stderr)
    for key, c in out["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
