"""End-to-end observability demo on the PyTorch port: serve a handful of
requests through the continuous-batching engine with the distributed
tracer and serving metrics attached, then write a Chrome trace you can
open at ui.perfetto.dev (DESIGN.md §16).

The engine runs on a (1, 2) rank mesh — two rank processes
(`core.spmd.run`) — so the per-step attention allreduces actually run
as collectives and the trace carries per-PE stage spans and cross-PE
flow links, plus an eager SIM collective on the 4x4 Epiphany mesh for
the NoC heatmap.  Rank 0 writes the documents.

Runs on the CUDA card unless given --device cpu.

Run:  PYTHONPATH=src python examples/pt_trace_serve.py [--device cpu]
Then: load bench-reports/trace_serve.json at ui.perfetto.dev
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import ShmemContext, SimNetOps, epiphany3  # noqa: E402
from repro_torch.core import spmd  # noqa: E402
from repro_torch.core.trace import LEVEL_FULL, Tracer  # noqa: E402
from repro_torch.launch import build  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.metrics import ServeMetrics  # noqa: E402

OUT_DIR = os.environ.get("BENCH_OUT_DIR", "bench-reports")


def trace_rank(out_dir):
    """One rank of the (1, 2) mesh: the traced engine; rank 0 adds the
    SIM collective and writes the documents.  Returns what it printed."""
    rt = spmd.current()
    tracer = Tracer(level=LEVEL_FULL)
    metrics = ServeMetrics()
    metrics.attach(tracer)

    # -- 1. serve a small request trace with tp=2 ----------------------------
    eng = ServeEngine(smoke_config("qwen2-0.5b"), rt.mesh,
                      max_slots=3, page_size=8, max_seq=32, prompt_bucket=16,
                      profile=tracer, metrics=metrics)
    rng = np.random.default_rng(0)
    with tracer.span("serve.session"):
        for n in (5, 9, 3, 12):
            eng.submit(rng.integers(1, eng.cfg.vocab, size=n,
                                    dtype=np.int32), 6)
        eng.run()
    if rt.rank != 0:
        return None
    lines = [f"[trace_serve] served {len(eng.results)} requests in "
             f"{eng.steps} engine steps"]

    # -- 2. one eager SIM collective on the 4x4 mesh: stage spans + heatmap --
    sim = ShmemContext(SimNetOps(16, rt.device), topo=epiphany3(),
                       profile=tracer)
    with tracer.span("sim.allreduce_demo", n_pes=16):
        sim.to_all(torch.ones((16, 2048), dtype=torch.float32,
                              device=rt.device), algorithm="rd")

    # -- 3. export -----------------------------------------------------------
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "trace_serve.json")
    metrics_path = os.path.join(out_dir, "serve_metrics.json")
    tracer.dump_chrome(trace_path)
    metrics.dump(metrics_path)

    flows = sum(1 for e in tracer._events if e.get("ph") == "s")
    lines.append(f"[trace_serve] {len(tracer._events)} events "
                 f"({flows} cross-PE flow links) -> {trace_path}")
    lines.append(f"[trace_serve] ttft p50 = "
                 f"{metrics.ttft_s.percentile(50) * 1e3:.1f}ms, per-token "
                 f"p50 = {metrics.per_token_s.percentile(50) * 1e3:.2f}ms "
                 f"-> {metrics_path}")
    return {"lines": lines, "results": {k: v.tolist() for k, v in
                                        eng.results.items()},
            "events": len(tracer._events), "flows": flows,
            "trace": trace_path, "metrics": metrics_path}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    got = build.shard_mapped(trace_rank, (1, 2), [(args.out_dir,)] * 2,
                             device=device)[0]
    for line in got["lines"]:
        print(line)
    print("[trace_serve] open the trace at https://ui.perfetto.dev")
    return got


if __name__ == "__main__":
    main()
