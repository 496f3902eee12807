"""Training launcher: real steps on one device (the CUDA card, or the CPU
with --device cpu), with checkpoint/restart and straggler records.

  python -m repro_torch.launch.train --arch qwen2-0.5b
  python -m repro_torch.launch.train --arch qwen2-0.5b --smoke --device cpu \\
         --steps 12 --ckpt-dir /tmp/ckpt --resume auto
  python -m repro_torch.launch.train --arch hubert-xlarge --smoke --device cpu
  python -m repro_torch.launch.train --arch phi-3-vision-4.2b --smoke \\
         --device cpu

The audio frontend trains on stub frames (B, L, d_model) and the vision
one on stub frontend embeds (B, n_frontend_tokens, d_model) beside the
tokens, as the reference's launcher makes them (at d_model where the
reference's pipeline draws width 1: `data/pipeline.py`).

The flags of the reference launcher whose services are not ported yet
are accepted and refused with the slice that brings them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

# reference flags refused here: (flag, value meaning "not asked for",
# the slice that brings the service)
_UNPORTED = [
    ("data", 1, "slice 5 (the multi-device backend)"),
    ("model", 1, "slice 5 (the multi-device backend)"),
    ("pod", 0, "slice 5 (the multi-device backend)"),
    ("topo", None, "slice 5 (topology-aware selection on a real mesh)"),
    ("embedding", "off", "slice 5 (mesh embeddings on a real mesh)"),
    ("autotune", False, "slice 5 (the tuner)"),
    ("tuning_db", "", "slice 5 (the tuner)"),
    ("profile_out", "", "slice 5 (the profiler)"),
    ("trace_out", "", "slice 5 (the tracer)"),
    ("metrics_out", "", "slice 5 (the metrics registry)"),
    ("allreduce_algo", "paper", "slice 5 (cost-model selection on a real "
                                "mesh)"),
    ("pipeline_chunks", None, "slice 5 (chunked collectives on a real "
                              "mesh)"),
    ("shard_strategy", None, "slice 5 (sharding strategies)"),
]


@dataclasses.dataclass
class TrainRun:
    """What `run` returns: the losses and host wall time of each step
    (each ends in a read of the loss, which waits for the device), and
    the final parameters and optimizer state."""
    losses: list
    step_s: list
    params: dict
    opt_state: dict


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-rs", default="off",
                    choices=["off", "on", "auto"],
                    help="bucketed reduce-scatter + allgather gradient "
                         "sync; auto switches on above GRAD_RS_AUTO_BYTES "
                         "of synced gradient")
    ap.add_argument("--remat", default=None, choices=[None, "none", "full"],
                    help="override the config's remat policy")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--step-deadline", type=float, default=600.0,
                    help="per-step straggler deadline (seconds): a step "
                         "exceeding it is recorded as a straggler event")
    ap.add_argument("--ckpt-async", default="on", choices=["on", "off"],
                    help="off: periodic saves block the train loop; on: "
                         "saves snapshot to host and write on a thread")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--pod", type=int, default=0)
    ap.add_argument("--topo", default=None)
    ap.add_argument("--embedding", default="off",
                    choices=["off", "auto", "snake"])
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--tuning-db", default="")
    ap.add_argument("--profile-out", default="")
    ap.add_argument("--trace-out", default="")
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--allreduce-algo", default="paper",
                    choices=["paper", "auto"])
    ap.add_argument("--pipeline-chunks", default=None)
    ap.add_argument("--shard-strategy", default=None,
                    choices=[None, "tp", "dp_only"])
    return ap


def run(argv=None) -> TrainRun:
    """Parse `argv` and train; `main` without the return of state."""
    ap = _parser()
    args = ap.parse_args(argv)
    for name, unset, slice_ in _UNPORTED:
        if getattr(args, name) != unset:
            ap.error(f"--{name.replace('_', '-')} is not ported yet: it "
                     f"comes with {slice_}")

    from .. import resolve_device
    from ..ckpt import manager as ckpt
    from ..configs import get_config, smoke_config
    from ..data.pipeline import SyntheticLM, frontend_kwargs
    from ..models import transformer
    from ..train import optimizer as opt
    from ..train import step as tstep

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    device = resolve_device(args.device)
    pipe = SyntheticLM(cfg.vocab, args.seq_len, args.batch,
                       **frontend_kwargs(cfg))
    adamw = opt.AdamWConfig(lr=args.lr, moment_dtype=cfg.moment_dtype)
    grad_rs = {"off": False, "on": True, "auto": "auto"}[args.grad_rs]
    step_fn = tstep.build_train_step(cfg, adamw=adamw, grad_rs=grad_rs)
    params = transformer.init_params(cfg, seed=0, device=device)
    opt_state = opt.init_state(params, adamw, cfg.local_global_period)

    start = 0
    ft = None
    if args.ckpt_dir:
        ft = ckpt.FaultToleranceManager(
            args.ckpt_dir, save_every=args.ckpt_every,
            step_deadline_s=args.step_deadline,
            async_save=args.ckpt_async == "on")
        if args.resume == "auto" and ft.resume_step() is not None:
            start, restored = ckpt.restore(
                args.ckpt_dir, {"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            print(f"[train] resumed from step {start}")

    losses, step_s = [], []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        loss, params, opt_state = step_fn(params, opt_state,
                                          pipe.batch(step))
        loss = float(loss)        # waits for the device: the step's end
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"[train] step {step:5d} loss {loss:8.4f} "
              f"({step_s[-1]:.2f}s)")
        if ft:
            ft.on_step(step, lambda: {"params": params, "opt": opt_state})
    if ft:
        ft.finalize(args.steps, lambda: {"params": params,
                                         "opt": opt_state})
        if ft.stragglers:
            print(f"[train] {len(ft.stragglers)} step(s) exceeded "
                  f"--step-deadline {args.step_deadline:g}s (worst "
                  f"{max(s['stall_s'] for s in ft.stragglers):.1f}s)")
    if not np.isfinite(losses).all():
        raise FloatingPointError(f"non-finite loss: {losses}")
    if len(losses) >= 10:
        a, b = np.mean(losses[:3]), np.mean(losses[-3:])
        print(f"[train] loss {a:.4f} -> {b:.4f} "
              f"({'improved' if b < a else 'no improvement'})")
    return TrainRun(losses, step_s, params, opt_state)


def main(argv=None):
    """Train; returns the list of step losses."""
    return run(argv).losses


if __name__ == "__main__":
    main()
