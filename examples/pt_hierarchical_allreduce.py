"""Hierarchical two-level allreduce over mesh row teams, on the PyTorch
port (DESIGN.md §11).

Splits a 2D mesh into row teams, runs the hierarchical allreduce
(intra-row reduce-scatter -> cross-row allreduce among the chunk owners
-> intra-row allgather), checks it against the flat algorithms, and shows
the cost model choosing flat vs hierarchical per message size — including
on a two-tier mesh whose cross axis costs 10x (the §8 pod story).

Runs on the CUDA card unless given --device cpu.

  PYTHONPATH=src python examples/pt_hierarchical_allreduce.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import abmodel, sim_ctx  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core import team as team_mod  # noqa: E402
from repro_torch.core.topology import MeshTopology, epiphany3  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    topo = epiphany3()                       # the paper's 4x4 chip
    n = topo.n_pes
    ctx = sim_ctx(n, topo, device=device)

    rows = ctx.team_split_2d()               # row teams (axis=-1)
    cols = rows.complement()                 # every row's rank-j members
    print(f"mesh {topo.shape}: {rows.n_teams} row teams x {rows.size} PEs; "
          f"row 1 = {rows.teams[1].members}, peer team 1 = "
          f"{cols.teams[1].members}")

    x = torch.as_tensor(np.random.RandomState(0).randn(n, 4096)
                        .astype(np.float32), device=device)
    flat = ctx.to_all(x, "sum", algorithm="ring")
    hier = ctx.to_all(x, "sum", algorithm="hier", partition=rows)
    err = float((flat - hier).abs().max())
    assert torch.allclose(flat, hier, rtol=2e-4, atol=1e-5), err
    print(f"hier == flat ring within float tolerance (max |diff| {err:.2e})")

    xi = torch.as_tensor((np.arange(n * 512) % 251).reshape(n, 512)
                         .astype(np.int32), device=device)
    assert torch.equal(
        ctx.to_all(xi, "sum", algorithm="hier", partition=rows),
        ctx.to_all(xi, "sum", algorithm="ring"))
    print("hier == flat EXACTLY for int dtypes")

    # a team-scoped reduction through the 1.3 active-set shim
    shim = ctx.to_all(x, "sum", PE_start=0, logPE_stride=2, PE_size=4)
    explicit = ctx.to_all(x, "sum",
                          team=team_mod.from_active_set(0, 2, 4, n))
    assert torch.equal(shim, explicit)
    print("active-set (PE_start=0, logPE_stride=2, PE_size=4) == explicit "
          "team API")

    # cost-model selection: flat for tiny messages, hier beyond the
    # cross-over; on the podded mesh even against chunked flat execution
    link = abmodel.EPIPHANY_NOC
    picks = {}
    for nbytes in (64, 4096, 1 << 20):
        algo = coll.choose_algorithm(n, float(nbytes), topo, link,
                                     partition=rows)
        picks[nbytes] = algo
        t_hier = coll.allreduce_hier_schedule(
            rows, float(nbytes), topo=topo, link=link).time(topo, link)
        t_ring = coll.allreduce_schedule(n, float(nbytes), "ring")\
            .time(topo, link)
        print(f"  {nbytes:>8}B: choose_algorithm={algo:<5} "
              f"(hier {t_hier * 1e6:8.2f}us vs flat ring "
              f"{t_ring * 1e6:8.2f}us)")

    podded = MeshTopology(shape=(8, 8), torus=(False, True),
                          link_cost=(10.0, 1.0))
    prows = team_mod.split_2d(team_mod.team_world(podded.n_pes), podded, -1)
    algo, chunks = coll.choose_schedule(podded.n_pes, float(1 << 18),
                                        podded, abmodel.ICI_V5E,
                                        partition=prows)
    print(f"podded 8x8 (cross axis 10x), 256KiB: choose_schedule picks "
          f"({algo}, chunks={chunks})")
    assert algo == "hier"
    print("OK")
    return picks


if __name__ == "__main__":
    main()
