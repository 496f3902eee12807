"""Checkpointing and fault tolerance (port of `repro/ckpt/manager.py`,
numpy on disk).

  * save(): each leaf of the state tree is written as a .npy under a temp
    dir, then the dir is renamed into place: a crash mid-save never
    corrupts the latest checkpoint.  A manifest records the step and
    every leaf's name, shape and dtype.
  * restore(): loads into a template, on the template's devices and in
    its dtypes.  A leaf whose saved shape differs from the template's
    (an elastic shrink or grow) is resharded on the host from the saved
    global array: tiled or sliced along each changed dim.  With
    `shardings` (a spec tree), in a rank process, each leaf is then cut
    to the rank's block.
  * A LATEST pointer at a deleted or partial dir falls back to the newest
    COMPLETE ``step-*`` dir; corruption surfaces as `CheckpointError`.
  * FaultToleranceManager: step-deadline straggler records, periodic
    saves (synchronous, or on a background thread after a host
    snapshot), resume bookkeeping.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from ..core.heap import tree_flatten, tree_unflatten


class CheckpointError(RuntimeError):
    """A checkpoint could not be resolved or is structurally incomplete
    (no complete step dir, dangling LATEST with no fallback, a manifest
    leaf the template needs that the checkpoint lacks)."""


def _leaf_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) pairs in `tree_flatten` order; names join dict keys
    and list indices with "/"."""
    if isinstance(tree, dict):
        return [nl for k in sorted(tree)
                for nl in _leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [nl for i, v in enumerate(tree)
                for nl in _leaf_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _host_copy(leaf):
    """A copy of `leaf` in host memory that later steps cannot change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_numpy(leaf) -> np.ndarray:
    """`leaf` as a numpy array; bf16 (which numpy lacks) as its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str | pathlib.Path, step: int, state: dict,
         extra_meta: dict | None = None) -> pathlib.Path:
    """Atomic checkpoint: write to <dir>/tmp-<step>, rename to
    <dir>/step-<step>, update LATEST last."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp-{step}"
    final = ckpt_dir / f"step-{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": [], **(extra_meta or {})}
    for name, leaf in _leaf_paths(state):
        arr = _to_numpy(leaf)
        fn = hashlib.md5(name.encode()).hexdigest()[:16] + ".npy"
        np.save(tmp / fn, arr)
        dtype = (str(leaf.dtype) if isinstance(leaf, torch.Tensor)
                 else str(arr.dtype))
        manifest["leaves"].append({"name": name, "file": fn,
                                   "shape": list(arr.shape), "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    (ckpt_dir / "LATEST.tmp").write_text(final.name)
    (ckpt_dir / "LATEST.tmp").rename(ckpt_dir / "LATEST")
    return final


def _is_complete(d: pathlib.Path) -> bool:
    """A step dir is COMPLETE when its manifest parses and every leaf file
    it names exists."""
    mf = d / "manifest.json"
    if not mf.exists():
        return False
    try:
        manifest = json.loads(mf.read_text())
    except (json.JSONDecodeError, OSError):
        return False
    return all((d / l["file"]).exists() for l in manifest.get("leaves", []))


def _complete_steps(ckpt_dir: pathlib.Path) -> list[pathlib.Path]:
    """All complete step-* dirs, newest first."""
    return sorted((d for d in ckpt_dir.glob("step-*")
                   if d.is_dir() and _is_complete(d)),
                  key=lambda d: d.name, reverse=True)


def _resolve_dir(ckpt_dir: str | pathlib.Path) -> pathlib.Path:
    """The step dir to restore from: LATEST when it points at a complete
    dir, else the newest complete ``step-*``; CheckpointError when
    nothing complete exists."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    p = ckpt_dir / "LATEST"
    if p.exists():
        d = ckpt_dir / p.read_text().strip()
        if _is_complete(d):
            return d
    fallback = _complete_steps(ckpt_dir)
    if fallback:
        return fallback[0]
    raise CheckpointError(
        f"no complete checkpoint under {ckpt_dir}: LATEST is "
        f"{'dangling or partial' if p.exists() else 'absent'} and no "
        f"complete step-* dir exists to fall back to")


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    try:
        d = _resolve_dir(ckpt_dir)
    except CheckpointError:
        return None
    return json.loads((d / "manifest.json").read_text())["step"]


def restore(ckpt_dir: str | pathlib.Path, template: dict,
            shardings=None) -> tuple[int, dict]:
    """(step, state) restored into `template`, a tree of tensors (GLOBAL
    shapes): each leaf comes back in the template leaf's dtype, on its
    device, resharded (`_reshard`) where its saved shape differs.
    `shardings`, a spec tree of the template's structure (a
    `parallel.sharding` spec a leaf: a tuple of None, axis names or
    tuples of them), places the state on the rank mesh: the call is made
    in a rank process of `core.spmd.run`, and each leaf comes back as
    this rank's block of it under its spec (`models.convert.local_leaf`
    at the rank's coordinates), as `jax.device_put(arr, NamedSharding)`
    gives the reference's device its block.  Raises CheckpointError when
    no complete checkpoint exists or it lacks a leaf the template
    names."""
    specs = None
    if shardings is not None:
        from ..core import spmd
        from ..parallel.sharding import spec_leaves
        mesh = spmd.current().mesh if spmd.active() else None
        if mesh is None:
            raise RuntimeError("restore(shardings=) places leaves on the "
                               "rank mesh: call it in a rank process, "
                               "after launch.mesh.make_mesh")
        from ..models.convert import local_leaf
        specs = spec_leaves(template, shardings)
    d = _resolve_dir(ckpt_dir)
    manifest = json.loads((d / "manifest.json").read_text())
    by_name = {l["name"]: l for l in manifest["leaves"]}
    _, treedef = tree_flatten(template)
    out = []
    for i, (name, t) in enumerate(_leaf_paths(template)):
        rec = by_name.get(name)
        if rec is None:
            have = ", ".join(sorted(by_name)[:8])
            raise CheckpointError(
                f"checkpoint {d.name} has no leaf {name!r} (template and "
                f"checkpoint disagree on state structure; checkpoint "
                f"holds: {have}{', ...' if len(by_name) > 8 else ''})")
        leaf = torch.from_numpy(np.load(d / rec["file"]))
        if rec["dtype"] == str(torch.bfloat16):
            leaf = leaf.view(torch.bfloat16)
        if tuple(leaf.shape) != tuple(t.shape):
            leaf = _reshard(leaf, tuple(t.shape), name).contiguous()
        if specs is not None:
            leaf = local_leaf(leaf, specs[i] or (), mesh)
        out.append(leaf.to(device=t.device, dtype=t.dtype))
    return manifest["step"], tree_unflatten(treedef, out)


def _reshard(arr: torch.Tensor, target: tuple[int, ...], name: str
             ) -> torch.Tensor:
    """Elastic shape adaptation (same rank): tile or slice along changed
    dims — used when global shapes legitimately change (e.g. optimizer
    flat buffers after an mb change); params keep global shapes across
    mesh changes so this rarely triggers."""
    if arr.ndim != len(target):
        raise ValueError(f"{name}: rank change {tuple(arr.shape)} -> "
                         f"{target}")
    for ax, (a, b) in enumerate(zip(arr.shape, target)):
        if a == b:
            continue
        if a < b:
            reps = [1] * arr.ndim
            reps[ax] = -(-b // a)
            arr = arr.repeat(*reps)
        arr = arr.narrow(ax, 0, b)
    return arr


@dataclasses.dataclass
class FaultToleranceManager:
    """Periodic checkpoints, straggler detection, restart bookkeeping."""

    ckpt_dir: str
    save_every: int = 100
    step_deadline_s: float = 600.0
    async_save: bool = True
    _last_t: float = dataclasses.field(default_factory=time.time)
    _pending: threading.Thread | None = None
    stragglers: list = dataclasses.field(default_factory=list)

    def on_step(self, step: int, state_fn: Callable[[], dict],
                meta: dict | None = None):
        """Call every train step.  state_fn is lazy, so nothing is copied
        to the host unless a save fires."""
        now = time.time()
        dt = now - self._last_t
        self._last_t = now
        if dt > self.step_deadline_s:
            self.stragglers.append({"step": step, "stall_s": dt})
        if step == 0 or step % self.save_every:
            return
        if not self.async_save:
            save(self.ckpt_dir, step, state_fn(), extra_meta=meta)
            return
        # snapshot to HOST before the thread exists: the next step
        # replaces the state this save means
        snap = {n: _host_copy(l) for n, l in _leaf_paths(state_fn())}
        self._join()
        self._pending = threading.Thread(
            target=save, args=(self.ckpt_dir, step, snap),
            kwargs={"extra_meta": meta}, daemon=False)
        self._pending.start()

    def _join(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def finalize(self, step: int, state_fn: Callable[[], dict],
                 meta: dict | None = None):
        self._join()
        save(self.ckpt_dir, step, state_fn(), extra_meta=meta)

    def resume_step(self) -> int | None:
        return latest_step(self.ckpt_dir)
