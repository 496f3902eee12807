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

--profile-out/--trace-out attach the profiler or the Chrome-trace tracer
(each step is one device-inclusive "train_step" op) and write their
documents at exit; --metrics-out records the per-step wall-time
histogram and the loss gauge; --autotune/--tuning-db hand the step a
measured tuner (on one device no collective consults it, and, as in the
reference at --data 1, there is no calibration sweep).

The flags of the reference launcher whose services are not ported yet
are accepted and refused with the slice that brings them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np

# reference flags refused here: (flag, value meaning "not asked for",
# the slice that brings the service)
_SPMD = "slice 5's SPMD item"
_UNPORTED = [
    ("data", 1, f"{_SPMD} (the multi-device backend)"),
    ("model", 1, f"{_SPMD} (the multi-device backend)"),
    ("pod", 0, f"{_SPMD} (the multi-device backend)"),
    ("topo", None, f"{_SPMD} (topology-aware selection on a real mesh)"),
    ("embedding", "off", f"{_SPMD} (mesh embeddings on a real mesh)"),
    ("allreduce_algo", "paper", f"{_SPMD} (cost-model selection on a "
                                "real mesh)"),
    ("pipeline_chunks", None, f"{_SPMD} (chunked collectives on a real "
                              "mesh)"),
    ("shard_strategy", None, f"{_SPMD} (sharding strategies)"),
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
    ap.add_argument("--autotune", action="store_true",
                    help="measured-performance selection: every 'auto' "
                         "selection consults the tuning DB first")
    ap.add_argument("--tuning-db", default="",
                    help="path of the persistent tuning database (JSON); "
                         "loaded when it exists, saved after the run")
    ap.add_argument("--profile-out", default="",
                    help="attach the pcontrol-style runtime profiler and "
                         "dump its JSON (counters + per-step timeline) "
                         "here at exit")
    ap.add_argument("--trace-out", default="",
                    help="attach the tracer and dump a Chrome trace-event "
                         "JSON here at exit (open in ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default="",
                    help="record per-step wall-time histogram + loss "
                         "gauge and dump the registry JSON here at exit")
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
    profiler = None
    if args.trace_out:
        from ..core.trace import LEVEL_FULL, Tracer
        profiler = Tracer(level=LEVEL_FULL)
    elif args.profile_out:
        from ..core.profile import Profiler
        profiler = Profiler(level=2)
    metrics = None
    if args.metrics_out:
        from ..serve.metrics import MetricsRegistry
        metrics = MetricsRegistry()
    tuner = None
    if args.autotune or args.tuning_db:
        from ..core import tuner as tuner_mod
        tuner = tuner_mod.Tuner(path=args.tuning_db or None)
    step_fn = tstep.build_train_step(
        cfg, adamw=adamw, grad_rs=grad_rs,
        autotune=tuner if args.autotune else None, profile=profiler)
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
        with (profiler.op("train_step", n_pes=1, device=device)
              if profiler is not None else contextlib.nullcontext()):
            loss, params, opt_state = step_fn(params, opt_state,
                                              pipe.batch(step))
            loss = float(loss)    # waits for the device: the step's end
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if metrics is not None:
            metrics.histogram("train.step_s",
                              "full train step wall time").observe(
                step_s[-1])
            metrics.gauge("train.loss", "last step loss").set(loss)
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
        if metrics is not None:
            metrics.counter(
                "train.stragglers",
                "steps exceeding the --step-deadline").inc(
                len(ft.stragglers))
    if tuner is not None and args.tuning_db:
        tuner.save(args.tuning_db)
        print(f"[train] tuning DB ({len(tuner.db)} points) saved to "
              f"{args.tuning_db}")
    if profiler is not None and args.profile_out:
        profiler.dump(args.profile_out)
        print(f"[train] profile dumped to {args.profile_out}")
    if args.trace_out:
        profiler.dump_chrome(args.trace_out)
        print(f"[train] Chrome trace ({len(profiler._events)} events) "
              f"written to {args.trace_out} — open in ui.perfetto.dev")
    if metrics is not None:
        metrics.counter("train.steps", "steps executed").inc(len(losses))
        metrics.dump(args.metrics_out)
        print(f"[train] metrics written to {args.metrics_out}")
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
