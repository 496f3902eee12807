"""The dry run on the port (`repro_torch.launch.dryrun`) against the
reference's (`repro.launch.dryrun`), on the CPU, compiling nothing.

The reference's `abstract_params`, `make_train_step` (its optimizer-state
shapes) and `make_serve_steps` (its cache shapes) read a mesh only
through `mesh_dims`, so a stub with `axis_names` and `devices =
np.empty((16, 16))` (or `(2, 16, 16)`) stands in for its 256 or 512
devices.  Held here:

  * every cell's name, status and skip reason, and the skipped cells'
    JSON, as the reference's; the FAILED line and exit code 1;
  * for each of the ten archs at both production meshes, every leaf's
    per-rank shape and dtype of the parameters, the optimizer state and
    the decode caches, as the reference's (its stacked layer dim is the
    port's list of layers);
  * the meta rank's heap rounds (shmem) and library calls (xla) of one
    step of smoke qwen2 on a 2x2 mesh, and its argument bytes, equal to
    what 4 real CPU rank processes count and hold for the same step
    (`RankContext.rounds`, `lib_calls`; small heap slots, so payloads
    cross in chunks on both sides);
  * the cell JSON's keys for a train, prefill and decode step, on a
    data x model and a pod mesh;
  * granite's smoke MoE layer, forward and backward, on a meta rank of
    1x4.
"""
import contextlib
import dataclasses
import io
import json
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.core import spmd
from repro_torch.core.heap import tree_flatten
from repro_torch.launch import build, dryrun
from repro_torch.launch.mesh import RankMesh, make_production_mesh
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.train import optimizer as opt

QWEN, GRANITE = "qwen2-0.5b", "granite-moe-3b-a800m"
MESHES = [False, True]
MESH_IDS = ["16x16", "2x16x16"]
SLOT = 1 << 14                 # heap slot bytes: payloads cross in chunks
STEP_BATCH = (8, 16)           # the 2x2 step's global batch (B, L)
KINDS = ("memory", "roofline", "collectives")
MEMORY = ("argument_bytes", "output_bytes", "alias_bytes", "temp_bytes",
          "peak_bytes")
ROOFLINE = ("compute_s", "memory_s", "collective_s", "hlo_flops",
            "hlo_bytes", "collective_bytes")
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")


def _stub(multipod: bool):
    shape = (2, 16, 16) if multipod else (16, 16)
    names = ("pod", "data", "model") if multipod else ("data", "model")
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _ref_leaves(tree) -> dict:
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = leaf
    return out


def _paths(tree, path=()):
    """(path, leaf) of a port tree in `tree_flatten`'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (str(i),))
    else:
        yield path, tree


def _param_path(path, cfg):
    """(the reference's path of a port parameter, whether it is stacked:
    one of a list of layers the reference stacks)."""
    if path[0] in ("layers", "dense_layers"):
        head = [path[0]]
        if cfg.local_global_period is not None and path[0] == "layers":
            head = ["pairs", "local" if int(path[1]) % 2 == 0 else "global"]
        return "/".join(head + list(path[2:])), True
    return "/".join(path), False


def _hold(got: dict, want: dict, what: str) -> None:
    """`got`: reference path -> [(shape, dtype, stacked)] from the port;
    each entry equal to the reference leaf (without its stacked dim, as
    many entries as it has layers)."""
    assert sorted(got) == sorted(want), what
    for name, leaves in got.items():
        ref = want[name]
        shape, dt = tuple(ref.shape), _dtype(ref.dtype)
        if leaves[0][2]:
            assert len(leaves) == shape[0], (what, name)
            shape = shape[1:]
        else:
            assert len(leaves) == 1, (what, name)
        for s, d, _ in leaves:
            assert (s, d) == (shape, dt), (what, name, s, d, shape, dt)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def test_archs_and_shapes_are_the_references():
    from repro.configs import ARCHS as JARCHS
    from repro.models.config import SHAPES as JSHAPES
    assert sorted(ARCHS) == sorted(JARCHS)
    assert SHAPES == JSHAPES


@pytest.mark.parametrize("comm", ["shmem", "xla"])
@pytest.mark.parametrize("multipod", MESHES, ids=MESH_IDS)
def test_cells_names_status_and_reasons_equal_the_reference(tmp_path, comm,
                                                            multipod):
    """Every (arch x shape) cell: the name, the status and the skip
    reason of the reference's `run_cell` (its compile stopped where the
    mesh is made: past `shape_applicable`), the skipped cells' JSON
    files byte for byte, and an ok cell's name, status and n_chips."""
    import repro.launch.mesh as jmesh
    from repro.launch import dryrun as jdry

    class Traced(Exception):
        pass

    mesh_name = "2x16x16" if multipod else "16x16"
    with mock.patch.object(jmesh, "make_production_mesh",
                           side_effect=Traced), \
            mock.patch.object(dryrun, "trace_step", return_value={}), \
            contextlib.redirect_stdout(io.StringIO()):
        for arch in ARCHS:
            for shape in SHAPES:
                got = dryrun.run_cell(arch, shape, multipod, comm,
                                      tmp_path / "port", verbose=False)
                cell = f"{arch}__{shape}__{mesh_name}__{comm}"
                try:
                    want = jdry.run_cell(arch, shape, multipod, comm,
                                         tmp_path / "ref", verbose=False)
                except Traced:
                    assert got == {"cell": cell, "status": "ok",
                                   "n_chips": 512 if multipod else 256}
                    continue
                assert want["status"] == "skipped"
                assert got == want
                assert (tmp_path / "port" / f"{cell}.json").read_text() == \
                    (tmp_path / "ref" / f"{cell}.json").read_text()
    assert sorted(p.name for p in (tmp_path / "ref").iterdir()) == \
        sorted(p.name for p in (tmp_path / "port").iterdir()
               if json.loads(p.read_text())["status"] == "skipped")


def test_a_failed_cell_prints_failed_and_exits_1(tmp_path):
    out = io.StringIO()
    with mock.patch.object(dryrun, "run_cell",
                           side_effect=ValueError("boom")), \
            contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", QWEN, "--shape", "train_4k", "--outdir",
                     str(tmp_path)])
    assert e.value.code == 1
    assert out.getvalue().splitlines() == [
        f"[dryrun] {QWEN}__train_4k: FAILED ValueError: boom",
        "1 cells failed"]


# ---------------------------------------------------------------------------
# per-rank leaves at the production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multipod", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_per_rank_leaves_equal_the_reference(arch, multipod):
    """Parameters (`abstract_params`), optimizer state (`opt.init_state`
    against the reference's `make_train_step` state shapes) and every
    decode cell's cache (`make_serve_steps`): shape and dtype a leaf, a
    rank of the production mesh."""
    from repro.configs import get_config as jget
    from repro.launch import build as jbuild
    cfg, jcfg = get_config(arch), jget(arch)
    mesh, jmesh = make_production_mesh(multi_pod=multipod), _stub(multipod)

    _, (jp, _), (jo, _), jocfg = jbuild.make_train_step(jcfg, jmesh)
    shapes, _ = build.abstract_params(cfg, mesh)
    got = {}
    for path, leaf in _paths(shapes):
        name, stacked = _param_path(path, cfg)
        got.setdefault(name, []).append(
            (tuple(leaf.shape), _dtype(leaf.dtype), stacked))
    _hold(got, _ref_leaves(jp), "params")

    ocfg = opt.AdamWConfig(moment_dtype=cfg.moment_dtype)
    assert ocfg.moment_dtype == jocfg.moment_dtype
    ost = opt.init_state(shapes, ocfg, cfg.local_global_period)
    paths = [p for p, _ in _paths(shapes)]
    groups = opt.moment_groups(shapes, ocfg.moment_dtype,
                               cfg.local_global_period)
    got = {}
    for group, mv in zip(groups, ost["mv"]):
        name, stacked = _param_path(paths[group[0]], cfg)
        # an int8 group holds every layer of its stack, as the
        # reference's blocks of the stacked leaf
        stacked = stacked and len(group) == 1
        for which, leaf in _paths(mv):
            got.setdefault(f"mv/{name}/{'/'.join(which)}", []).append(
                (tuple(leaf.shape), _dtype(leaf.dtype), stacked))
    got["step"] = [(tuple(ost["step"].shape), _dtype(ost["step"].dtype),
                    False)]
    _hold(got, _ref_leaves(jo), "optimizer state")

    for shape in SHAPES:
        if SHAPES[shape]["kind"] != "decode" or \
                not shape_applicable(cfg, shape)[0]:
            continue
        _, _, (cache, _), _, ss = build.make_serve_steps(cfg, mesh, shape)
        _, _, (jc, _), _, jss = jbuild.make_serve_steps(jcfg, jmesh, shape)
        assert ss == jss
        got = {}
        for path, leaf in _paths(cache):
            group = path[0]
            if cfg.local_global_period is not None and group == "layers":
                group = "pairs_" + ("local" if int(path[1]) % 2 == 0
                                    else "global")
            got.setdefault("/".join((group,) + path[2:]), []).append(
                (tuple(leaf.shape), _dtype(leaf.dtype), True))
        _hold(got, _ref_leaves(jc), f"cache {shape}")


# ---------------------------------------------------------------------------
# the meta rank against real rank processes
# ---------------------------------------------------------------------------

def _step_cfg():
    """Smoke qwen2 with the full config's remat and microbatches."""
    return dataclasses.replace(smoke_config(QWEN), remat="full",
                               microbatches=2)


def _step_batch(cfg):
    rng = np.random.default_rng(3)
    return {k: rng.integers(1, cfg.vocab, size=STEP_BATCH).astype(np.int32)
            for k in ("tokens", "targets")}


def _nbytes(tree) -> int:
    return sum(t.nbytes if isinstance(t, np.ndarray)
               else t.numel() * t.element_size()
               for t in tree_flatten(tree)[0])


def rank_step(cfg, batch):
    """One rank: one train step under shmem, then one under xla, from
    its seed-0 shards; the heap rounds and library calls of each, and
    the bytes of its parameters, optimizer state and batch slice."""
    rt = spmd.current()
    mesh = rt.mesh
    init, _, _ = build.make_init_fn(cfg, mesh)
    params = init(0, rt.device)
    ocfg = opt.AdamWConfig(moment_dtype=cfg.moment_dtype)
    state = opt.init_state(params, ocfg, cfg.local_global_period)
    out = {"arg_bytes": _nbytes(params) + _nbytes(state)
           + _nbytes(build.local_batch(cfg, batch, mesh))}
    for comm in ("shmem", "xla"):
        step, _, _ = build.make_train_step(cfg, mesh, comm, donate=True)
        rounds, calls = rt.rounds, rt.lib_calls
        loss, params, state = step(params, state, batch)
        out[comm] = (rt.rounds - rounds, rt.lib_calls - calls)
    return out


@pytest.fixture(scope="module")
def real_ranks():
    cfg = _step_cfg()
    batch = _step_batch(cfg)
    return build.shard_mapped(rank_step, (2, 2), [(cfg, batch)] * 4,
                              device="cpu", slot_bytes=SLOT)


def _meta_batch(cfg):
    return {k: torch.empty(STEP_BATCH, dtype=torch.int32, device="meta")
            for k in ("tokens", "targets")}


@pytest.fixture(scope="module")
def meta_steps():
    cfg = _step_cfg()
    return {comm: [dryrun.trace_step(cfg, "train_4k",
                                     RankMesh(("data", "model"), (2, 2), r),
                                     comm, SLOT, _meta_batch(cfg))
                   for r in range(4)]
            for comm in ("shmem", "xla")}


def test_meta_rank_counts_the_real_ranks_heap_rounds(real_ranks,
                                                     meta_steps):
    for r, real in enumerate(real_ranks):
        meta = meta_steps["shmem"][r]
        assert real["shmem"] == (meta["heap_rounds"], meta["lib_calls"])
        assert meta["heap_rounds"] > 0 and meta["lib_calls"] == 0
        assert meta["collectives"]["counts"]["collective-permute"] == \
            meta["heap_rounds"]
        _keys_ok(meta)


def test_meta_rank_counts_the_real_ranks_library_calls(real_ranks,
                                                       meta_steps):
    for r, real in enumerate(real_ranks):
        meta = meta_steps["xla"][r]
        assert real["xla"] == (meta["heap_rounds"], meta["lib_calls"])
        assert meta["lib_calls"] > 0 and meta["heap_rounds"] == 0
        assert sum(meta["collectives"]["counts"].values()) == \
            meta["lib_calls"]


def test_meta_rank_argument_bytes_are_the_real_ranks(real_ranks,
                                                     meta_steps):
    for r, real in enumerate(real_ranks):
        for comm in ("shmem", "xla"):
            mem = meta_steps[comm][r]["memory"]
            assert mem["argument_bytes"] == real["arg_bytes"]
            assert mem["alias_bytes"] == real["arg_bytes"] - _nbytes(
                build.local_batch(_step_cfg(), _step_batch(_step_cfg()),
                                  RankMesh(("data", "model"), (2, 2), r)))
            assert mem["peak_bytes"] >= mem["argument_bytes"]
            assert mem["temp_bytes"] == mem["peak_bytes"] - \
                mem["argument_bytes"]


def _keys_ok(res: dict) -> None:
    assert all(k in res for k in KINDS)
    assert tuple(res["memory"]) == MEMORY
    assert tuple(res["roofline"]) == ROOFLINE
    assert tuple(res["collectives"]["bytes"]) == COLL_KINDS
    assert tuple(res["collectives"]["counts"]) == COLL_KINDS
    assert res["roofline"]["hlo_flops"] > 0 < res["roofline"]["hlo_bytes"]
    assert res["roofline"]["collective_bytes"] == \
        sum(res["collectives"]["bytes"].values())
    assert sum(res["kernel_launches"].values()) > 0


@pytest.mark.parametrize("dims", [(2, 2), (2, 2, 2)], ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("shape", [s for s in SHAPES if shape_applicable(
    smoke_config(QWEN), s)[0]])
def test_cell_json_keys(shape, dims):
    """A step of every kind qwen2 runs traces on a data x model and a pod
    mesh and fills the reference's keys; a decode cell donates its
    cache."""
    cfg = smoke_config(QWEN)
    names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    res = dryrun.trace_step(cfg, shape, RankMesh(names, dims, 0))
    _keys_ok(res)
    if SHAPES[shape]["kind"] == "decode":
        assert 0 < res["memory"]["alias_bytes"] < \
            res["memory"]["argument_bytes"]
    if SHAPES[shape]["kind"] == "prefill":
        assert res["memory"]["alias_bytes"] == 0


def test_granite_moe_layer_runs_on_a_meta_rank():
    """Granite's smoke MoE layer on a meta rank of 1x4 (experts over
    `model`): the output and aux of their shapes, the input's gradient,
    and the two exchanges and the allgather taken as heap rounds with
    their DMA launches; the dispatch reads no routing value on the
    host."""
    from repro_torch.kernels import put_copy
    from repro_torch.models import layers
    from repro_torch.parallel.comm import AxisSpec, Comm
    cfg = smoke_config(GRANITE)
    mesh = RankMesh(("data", "model"), (1, 4), 1)
    shapes, _ = build.abstract_params(cfg, mesh)
    p = shapes["layers"][0]["moe"]
    before = put_copy.dma_launches
    with spmd.meta_rank(mesh, SLOT) as rt:
        x = torch.empty((2, 8, cfg.d_model), dtype=cfg.dtype,
                        device="meta", requires_grad=True)
        out, aux = layers.moe(Comm(AxisSpec()), cfg, p, x)
        assert out.shape == x.shape and out.device.type == "meta"
        assert aux.shape == ()
        fwd = rt.rounds
        (g,) = torch.autograd.grad((out.float().sum() + aux), x)
        assert g.shape == x.shape
    assert fwd > 0 and rt.rounds > fwd
    assert put_copy.dma_launches - before >= rt.rounds


@pytest.mark.parametrize("arch", [QWEN, GRANITE])
def test_extrapolated_microbatches_equal_the_whole_trace(arch, monkeypatch):
    """A step of 6 microbatches traced at 2 and 3 and extrapolated
    (`TRACED_MICROBATCHES`) gives every reading of the step traced whole:
    counts, collectives, roofline and memory."""
    cfg = dataclasses.replace(smoke_config(arch), microbatches=6,
                              remat="full")
    mesh = RankMesh(("data", "model"), (2, 2), 0)
    batch = {k: torch.empty((24, 16), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    got = dryrun.trace_step(cfg, "train_4k", mesh, "shmem", SLOT, batch)
    monkeypatch.setattr(dryrun, "TRACED_MICROBATCHES", 6)
    want = dryrun.trace_step(cfg, "train_4k", mesh, "shmem", SLOT, batch)
    got.pop("trace_s"), want.pop("trace_s")
    assert got == want


# ---------------------------------------------------------------------------
# the kernels' meta paths
# ---------------------------------------------------------------------------

def _meta_t(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kept(lq, lk, causal, window, lk_valid):
    """Kernel 4's kept pairs by brute force over its mask."""
    q = torch.arange(lq)[:, None]
    k = torch.arange(lk)[None, :]
    keep = (k < lk_valid).expand(lq, lk)
    if causal:
        keep = keep & (k <= q)
    if window is not None:
        keep = keep & (k > q - window)
    return int(keep.sum())


@pytest.mark.parametrize("causal,window,lk_valid", [
    (True, None, 256), (False, None, 200), (True, 48, 256),
    (False, 33, 130)])
def test_flash_attention_meta_path_counts_the_kept_pairs(causal, window,
                                                         lk_valid):
    from repro_torch.kernels import _meta
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k = _meta_t((2, 6, 128, 24)), _meta_t((2, 3, 256, 24))
    v = _meta_t((2, 3, 256, 16))
    _meta.reset()
    before = fa.launches
    with mock.patch.object(ref, "attention_ref", side_effect=AssertionError):
        out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 lk_valid=lk_valid)
    assert out.shape == (2, 6, 128, 16) and out.device.type == "meta"
    assert fa.launches == before + 1
    pairs = _kept(128, 256, causal, window, lk_valid)
    assert _meta.work["flash_attention"] == {
        "launches": 1, "ops": 2 * (24 + 16) * pairs * 2 * 6,
        "bytes": 4 * (q.numel() + k.numel() + v.numel() + out.numel())}


def test_fused_update_and_combine_meta_paths():
    from repro_torch.kernels import _meta, ref
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import reduce_combine as rc
    p = _meta_t((1000,))
    mask = _meta_t((1000,), torch.int8)
    _meta.reset()
    before = (fu.launches, rc.launches)
    with mock.patch.object(ref, "fused_adam_ref",
                           side_effect=AssertionError), \
            mock.patch.object(ref, "reduce_combine_ref",
                              side_effect=AssertionError):
        new_p, m, v = fu.fused_adam([p, p], p, p, p, mask, 0.1, 0.2, lr=1e-3,
                                    b1=0.9, b2=0.95, eps=1e-8, wd_coef=0.1,
                                    out_dtype=torch.bfloat16)
        s = rc.reduce_combine([p, p, p], "max")
    assert (fu.launches, rc.launches) == (before[0] + 1, before[1] + 1)
    assert new_p.dtype == torch.bfloat16 and m.shape == v.shape == (1000,)
    assert s.shape == (1000,) and s.device.type == "meta"
    assert _meta.work["fused_update"] == {
        "launches": 1, "ops": 14 * 1000,
        "bytes": 1000 * (4 * 5 + 1 + 2 + 4 * 2)}
    assert _meta.work["reduce_combine"] == {"launches": 1, "ops": 2000,
                                            "bytes": 4 * 4000}


def test_meta_rank_is_no_rank_of_a_run():
    """Inside `meta_rank` the rank is active, on the meta device, with
    its mesh and no barrier; outside it, no rank is."""
    mesh = RankMesh(("data", "model"), (2, 2), 3)
    assert not spmd.active()
    with spmd.meta_rank(mesh, SLOT) as rt:
        assert spmd.active() and spmd.current() is rt
        assert rt.device.type == "meta" and rt.mesh is mesh
        assert (rt.rank, rt.world, rt.heap.slot_bytes) == (3, 4, SLOT)
        rt.barrier()
        assert rt.axis_group(mesh, "model").ranks == mesh.group("model")
        with pytest.raises(RuntimeError):
            with spmd.meta_rank(mesh):
                pass
    assert not spmd.active()
