"""Training launcher: real steps on one device (the CUDA card, or the CPU
with --device cpu), or on a (--pod x) --data x --model mesh of rank
processes sharing that device (`core.spmd`), with checkpoint/restart and
straggler records.

  python -m repro_torch.launch.train --arch qwen2-0.5b
  python -m repro_torch.launch.train --arch qwen2-0.5b --data 2 --model 2
  python -m repro_torch.launch.train --arch qwen2-0.5b --pod 2 --model 2
  python -m repro_torch.launch.train --arch qwen2-0.5b --smoke --device cpu \\
         --steps 12 --ckpt-dir /tmp/ckpt --resume auto
  python -m repro_torch.launch.train --arch hubert-xlarge --smoke --device cpu
  python -m repro_torch.launch.train --arch phi-3-vision-4.2b --smoke \\
         --device cpu

On a mesh every rank trains its local shards on its slice of the global
batch (`launch/build.make_train_step`; with --pod the batch splits over
(pod, data), pod-major, and the gradient sync reduces over `data`, then
across pods) and the launcher returns rank 0's losses; --ckpt-dir saves
the GLOBAL tree gathered from the ranks (each sharded leaf allgathered
over the axes its spec names), so a restore onto another mesh has what
the reference's has: with fsdp, data rank 0's rows of each per-layer
leaf, and int8 moments as rank 0 holds them (`train_loop`'s `state`).  --shard-strategy dp_only replicates the
parameters and splits the batch over data x model.  --topo,
--allreduce-algo, --pipeline-chunks and --embedding steer the mesh's
collectives as the reference's flags do; --comm xla runs them as the
library collectives over gloo instead of the paper's runtime
(`parallel/libcoll.py`; --grad-rs is then the reference's per-bucket
sync).

The audio frontend trains on stub frames (B, L, d_model) and the vision
one on stub frontend embeds (B, n_frontend_tokens, d_model) beside the
tokens, as the reference's launcher makes them (at d_model where the
reference's pipeline draws width 1: `data/pipeline.py`).

--profile-out/--trace-out attach the profiler or the Chrome-trace tracer
(each step is one device-inclusive "train_step" op) and write their
documents at exit (on a mesh, rank 0's); --metrics-out records the
per-step wall-time histogram and the loss gauge; --autotune/--tuning-db
hand the step a measured tuner (on one device no collective consults
it; on a data axis of more than one PE --autotune first calibrates with
the reference's small SIM sweep, once, before the ranks start).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time

import numpy as np

@dataclasses.dataclass
class TrainRun:
    """What `run` returns: the losses and host wall time of each step
    (each ends in a read of the loss, which waits for the device), and
    the final parameters and optimizer state (None on a mesh)."""
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
    ap.add_argument("--remat", default=None,
                    choices=[None, "none", "full", "selective"],
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
    ap.add_argument("--comm", default="shmem", choices=["shmem", "xla"],
                    help="the collectives' backend: the paper's runtime "
                         "or the library collectives")
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


def _topology(args):
    """The data axis's MeshTopology from --topo, or the reference's
    near-square guess when --embedding needs one; None otherwise.  With
    --pod and no --topo, --embedding is dropped (set "off" in `args`)
    with the reference's message: a guessed layout of the data axis
    would also price the pod axis's collectives."""
    from ..core.topology import MeshTopology
    if args.topo:
        shape = tuple(int(p) for p in args.topo.lower().split("x"))
        if int(np.prod(shape)) != args.data:
            raise SystemExit(f"--topo {args.topo} covers "
                             f"{int(np.prod(shape))} PEs but the data axis "
                             f"has {args.data}")
        return MeshTopology(shape, torus=(False,) * len(shape))
    if args.embedding != "off" and args.pod:
        print("[train] --embedding ignored: with --pod, pass --topo to "
              "state the data-axis layout explicitly")
        args.embedding = "off"
    elif args.embedding != "off":
        d, r = args.data, int(args.data ** 0.5)
        while r > 1 and d % r:
            r -= 1
        shape = (r, d // r) if r > 1 else (d,)
        print(f"[train] --embedding without --topo: assuming data-axis "
              f"layout {'x'.join(map(str, shape))} (pass --topo to state "
              f"the real one)")
        return MeshTopology(shape, torus=(False,) * len(shape))
    return None


def _chunks(args):
    c = args.pipeline_chunks
    return c if c is None or c == "auto" else int(c)


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags."""
    return _parser().parse_args(sys.argv[1:] if argv is None
                                else list(argv))


def _tuner(args, topo, device):
    """The measured tuner of --autotune/--tuning-db, or None.  On a data
    axis of more than one PE with no measurements for its fingerprint
    yet, --autotune first runs the reference's small SIM sweep on
    `device`; this happens once, in the launcher's process, so every
    rank selects from the same DB."""
    if not (args.autotune or args.tuning_db):
        return None
    from ..core import sim_ctx
    from ..core import tuner as tuner_mod
    tuner = tuner_mod.Tuner(path=args.tuning_db or None)
    if args.autotune and args.data > 1:
        fp = tuner_mod.fingerprint(topo, args.data)
        if not any(k.startswith(fp + "|") for k in tuner.db.entries):
            print(f"[train] autotune: calibrating {fp} (small SIM sweep)")
            summary = tuner.tune(
                sim_ctx(args.data, topo, device=device),
                {"collectives": ("allreduce",),
                 "sizes": (4096, 65536, 1 << 20),
                 "chunks": (1, 4), "iters": 3, "warmup": 1})
            print(f"[train] autotune: measured {summary['variants']} "
                  f"variants; best {summary['best']}")
    return tuner


def run(argv=None, *, params=None) -> TrainRun:
    """Parse `argv` and train; `main` without the return of state.
    `params`, when given, is the GLOBAL parameter tree (the port's
    layout) to start from in place of the seed-0 init.  On a mesh the
    result is rank 0's losses and step walls (with --ckpt-dir the
    checkpoint holds the GLOBAL tree gathered from the ranks)."""
    from .. import resolve_device
    args = parse_args(argv)
    device = resolve_device(args.device)
    topo = _topology(args)
    tuner = _tuner(args, topo, device)
    dims = (args.data, args.model) + ((args.pod,) if args.pod else ())
    n = int(np.prod(dims))
    if n == 1:
        return train_loop(args, params, topo, tuner)
    from . import build
    return build.shard_mapped(train_loop, dims,
                              [(args, params, topo, tuner)] * n,
                              device=device)[0]


def _gather_global(comm, specs, tree):
    """The GLOBAL tree of a rank's local `tree` (params, or f32/bf16
    moments of the same structure): each sharded leaf allgathered along
    its sharded dim over that dim's axis (`model`; the EP group's
    flattened (data, model) for the experts under `ep_over_data`; fsdp's
    (model, data) for an unstacked 2-D leaf, model-major)."""
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, sv) for v, sv in zip(t, s)]
        for dim, ax in enumerate(s):
            if ax is not None:
                t = comm.allgather(t, ax, concat_axis=dim)
        return t
    return walk(tree, specs)


def train_loop(args, params=None, topo=None, tuner=None, *,
               shards=None) -> TrainRun:
    """The launcher's loop on parsed `args`: in this process on one
    device, or, called in each rank process of a (--pod x) --data x
    --model mesh (`launch/build.shard_mapped`), on the rank's local
    shards of the GLOBAL `params` (or on `shards`: this rank's local
    shards, cut already and its own, so that no rank is handed the whole
    tree) and its slice of the global batch.  Checkpoints hold the
    GLOBAL tree (on a mesh every rank takes part in its gather); rank 0
    writes them, the log and the service documents.  On a mesh the
    result holds the losses and walls only (the checkpoint holds the
    trained tree), and a rank that owns its parameters (its own init, or
    `shards`) updates them in place (`build_train_step`'s `donate`): the
    state is not held twice."""
    from .. import resolve_device
    from ..ckpt import manager as ckpt
    from ..configs import get_config, smoke_config
    from ..core import spmd
    from ..core.heap import tree_flatten, tree_unflatten
    from ..data.pipeline import SyntheticLM, frontend_kwargs
    from ..models import convert, transformer
    from ..parallel import sharding
    from ..parallel.comm import Comm
    from ..train import optimizer as opt
    from ..train import step as tstep
    from . import build

    mesh = spmd.current().mesh if spmd.active() else None
    lead = mesh is None or spmd.current().rank == 0
    device = resolve_device(args.device) if mesh is None \
        else spmd.current().device
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    over = {}
    if args.remat:
        over["remat"] = args.remat
    if args.shard_strategy:
        over["shard_strategy"] = args.shard_strategy
    if over:
        cfg = dataclasses.replace(cfg, **over)
    pipe = SyntheticLM(cfg.vocab, args.seq_len, args.batch,
                       **frontend_kwargs(cfg))
    adamw = opt.AdamWConfig(lr=args.lr, moment_dtype=cfg.moment_dtype)
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
    knobs = dict(
        adamw=adamw, allreduce_algo=args.allreduce_algo,
        grad_rs={"off": False, "on": True, "auto": "auto"}[args.grad_rs],
        pipeline_chunks=_chunks(args), topo=topo,
        embedding=None if args.embedding == "off" else args.embedding,
        autotune=tuner if args.autotune else None, profile=profiler)
    if mesh is None:
        step_fn = tstep.build_train_step(cfg, backend=args.comm, **knobs)
        if params is None:
            params = transformer.init_params(cfg, seed=0, device=device)
    else:
        owned = params is None          # its own init, or `shards`
        step_fn, (_, specs), _ = build.make_train_step(
            cfg, mesh, args.comm, donate=owned, **knobs)
        if shards is not None:
            params = shards
        elif owned:
            params = build.make_init_fn(cfg, mesh, args.comm)[0](0, device)
        else:
            params = convert.local_shards(params, cfg, mesh)
    params = transformer.map_params(lambda t: t.to(device), params)
    opt_state = opt.init_state(params, adamw, cfg.local_global_period)
    if mesh is not None:
        comm = Comm(build.axis_spec(mesh, cfg), args.comm)
        spec_leaves = sharding.spec_leaves(params, specs)
        # int8 moments are flat blocks over the rank's own leaves: the
        # reference gives them the spec P(), so its checkpoint holds
        # rank 0's and every rank resumes with those
        grouped = adamw.moment_dtype == "int8"

    def state():
        """The GLOBAL {"params", "opt"}: each leaf gathered over the axes
        its spec names (`sharding.param_specs`, the reference's: a
        per-layer fsdp leaf is gathered over `model` alone, so the tree
        holds data rank 0's rows of it, as the reference's checkpoint
        does); int8 moments as this rank holds them."""
        if mesh is None:
            return {"params": params, "opt": opt_state}
        mv = opt_state["mv"] if grouped else [
            {k: _gather_global(comm, s, d[k]) for k in ("m", "v")}
            for d, s in zip(opt_state["mv"], spec_leaves)]
        return {"params": _gather_global(comm, specs, params),
                "opt": {"mv": mv, "step": opt_state["step"]}}

    def local(got):
        """This rank's (params, opt_state) of a restored GLOBAL state
        (`state`'s layout): each leaf cut to the rank's block of its
        spec."""
        if mesh is None:
            return got["params"], got["opt"]

        def cut(g, s, like):
            return convert.local_leaf(g, s, mesh).to(device=like.device,
                                                     dtype=like.dtype)

        mv, mdef = tree_flatten(opt_state["mv"])
        got_mv = tree_flatten(got["opt"]["mv"])[0]
        mv_specs = [()] * len(mv) if grouped else \
            [s for s in spec_leaves for _ in "mv"]
        p, pdef = tree_flatten(params)
        return (tree_unflatten(pdef, [
                    cut(g, s, t) for g, s, t in zip(
                        tree_flatten(got["params"])[0], spec_leaves, p)]),
                {"mv": tree_unflatten(mdef, [
                    cut(g, s, m) for g, m, s in zip(got_mv, mv, mv_specs)]),
                 "step": got["opt"]["step"].to(device)})

    start = 0
    ft = None
    if args.ckpt_dir:
        if lead:
            ft = ckpt.FaultToleranceManager(
                args.ckpt_dir, save_every=args.ckpt_every,
                step_deadline_s=args.step_deadline,
                async_save=args.ckpt_async == "on")
        if args.resume == "auto" and \
                ckpt.latest_step(args.ckpt_dir) is not None:
            start, got = ckpt.restore(args.ckpt_dir, state())
            params, opt_state = local(got)
            if lead:
                print(f"[train] resumed from step {start}")

    on = "" if mesh is None else \
        f" on {'x'.join(map(str, mesh.shape))} ranks"
    losses, step_s = [], []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        with (profiler.op("train_step",
                          n_pes=1 if mesh is None else mesh.size,
                          device=device)
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
        if lead:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"({step_s[-1]:.2f}s){on}")
        if ft:
            ft.on_step(step, state)
        elif args.ckpt_dir and step and step % args.ckpt_every == 0:
            state()               # this rank's part in rank 0's gather
    if ft:
        ft.finalize(args.steps, state)
        if ft.stragglers:
            print(f"[train] {len(ft.stragglers)} step(s) exceeded "
                  f"--step-deadline {args.step_deadline:g}s (worst "
                  f"{max(s['stall_s'] for s in ft.stragglers):.1f}s)")
        if metrics is not None:
            metrics.counter(
                "train.stragglers",
                "steps exceeding the --step-deadline").inc(
                len(ft.stragglers))
    elif args.ckpt_dir:
        state()
    if lead:
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
            metrics.counter("train.steps", "steps executed").inc(
                len(losses))
            metrics.dump(args.metrics_out)
            print(f"[train] metrics written to {args.metrics_out}")
    if not np.isfinite(losses).all():
        raise FloatingPointError(f"non-finite loss: {losses}")
    if lead and len(losses) >= 10:
        a, b = np.mean(losses[:3]), np.mean(losses[-3:])
        print(f"[train] loss {a:.4f} -> {b:.4f} "
              f"({'improved' if b < a else 'no improvement'})")
    if mesh is not None:
        params = opt_state = None
    return TrainRun(losses, step_s, params, opt_state)


def main(argv=None):
    """Train; returns the list of step losses (rank 0's on a mesh)."""
    return run(argv).losses


if __name__ == "__main__":
    main()
