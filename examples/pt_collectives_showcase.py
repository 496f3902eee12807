"""The paper's Figs. 3-9 in one script, on the PyTorch port: every
collective on the SIM backend, each held against its library analogue
(the torch op that computes the same result), then the modeled NoC stage
times of each and alpha-beta fits, as the reference's showcase.

Runs on the CUDA card unless given --device cpu.

Run:  PYTHONPATH=src python examples/pt_collectives_showcase.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import abmodel, epiphany3, sim_ctx  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402


def analogues(ctx, x):
    """Each collective on the SIM against its library analogue:
    (name, whether they agree)."""
    n = ctx.n_pes
    full = x.reshape(n, n, -1)           # PE p's block j for the alltoall
    return [
        ("broadcast", torch.equal(ctx.broadcast(x, 3),
                                  x[3].expand_as(x))),
        ("fcollect", torch.equal(ctx.fcollect(x),
                                 x.reshape(1, -1).expand(n, -1))),
        ("reduce", torch.allclose(ctx.to_all(x, "sum"),
                                  x.sum(0).expand_as(x),
                                  rtol=1e-5, atol=1e-5)),
        ("reduce(max)", torch.equal(ctx.to_all(x, "max"),
                                    x.amax(0).expand_as(x))),
        ("alltoall", torch.equal(
            ctx.alltoall(x).reshape(n, n, -1),
            full.transpose(0, 1))),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    topo = epiphany3()
    n = topo.n_pes
    ctx = sim_ctx(n, topo, device=device)
    link = abmodel.EPIPHANY_NOC

    x = torch.randn((n, 4 * n), generator=torch.Generator().manual_seed(0)
                    ).to(device)
    checks = analogues(ctx, x)
    for name, ok in checks:
        print(f"{name:>12}: SIM == library analogue: {ok}")
    if not all(ok for _, ok in checks):
        raise AssertionError("a collective disagrees with its analogue")

    rows = []
    for nbytes in [8 << i for i in range(8)]:
        stages = {
            "put": [(float(nbytes), 1.0)],
            "get(IPI)": [(float(nbytes), 1.0), (8.0, 1.0)],
            "broadcast": coll.broadcast_stages(n, nbytes, topo),
            "fcollect": coll.fcollect_stages(n, nbytes, topo),
            "reduce": coll.allreduce_stages(n, nbytes, topo),
            "alltoall": coll.alltoall_stages(n, nbytes * n, topo),
            "barrier": coll.barrier_stages(n, topo),
        }
        rows.append((nbytes, {k: abmodel.modeled_collective_time(v, link)
                              for k, v in stages.items()}))

    names = list(rows[0][1])
    print(f"{'bytes':>8} " + " ".join(f"{x:>12}" for x in names))
    for nbytes, r in rows:
        print(f"{nbytes:8d} " + " ".join(f"{r[k]*1e6:10.2f}us"
                                         for k in names))

    # alpha-beta fit, like the paper's figure subtitles
    fits = {}
    for op in ("put", "broadcast", "reduce"):
        fit = abmodel.fit([r[0] for r in rows], [r[1][op] for r in rows])
        fits[op] = fit
        print(f"{op}: alpha={fit.alpha*1e6:.3f}us  "
              f"beta^-1={fit.inv_beta/1e9:.3f} GB/s")
    return fits


if __name__ == "__main__":
    main()
