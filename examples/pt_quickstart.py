"""Quickstart: the paper's library, end to end, on the PyTorch port.

1. SHMEM collectives on a simulated 16-PE Epiphany-style mesh (the
   paper's platform), with alpha-beta timing fits like Figs. 3-9.
2. A tiny LM trained for a few steps over the same collectives, through
   the train launcher.

Runs on the CUDA card unless given --device cpu.

Run:  PYTHONPATH=src python examples/pt_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import abmodel, epiphany3, sim_ctx  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. the library on the paper's 4x4 chip --------------------------
    topo = epiphany3()
    ctx = sim_ctx(topo.n_pes, topo, device=device)
    x = torch.arange(topo.n_pes * 8, dtype=torch.float32,
                     device=device).reshape(topo.n_pes, 8)

    print("== ARL OpenSHMEM for Epiphany, in PyTorch ==")
    print("n_pes:", ctx.n_pes)
    print("broadcast(root=5) ok:",
          bool((ctx.broadcast(x, 5) == x[5]).all()))
    print("fcollect shape:", tuple(ctx.fcollect(x).shape))
    print("sum_to_all ok:",
          bool(np.allclose(ctx.to_all(x, "sum").cpu().numpy(),
                           x.cpu().numpy().sum(0))))
    ctx.barrier_all()
    print("dissemination barrier rounds:",
          len(coll.barrier_stages(ctx.n_pes, topo)))

    # modeled times on the Epiphany NoC (the paper's alpha-beta method)
    for nbytes in (64, 1024, 8192):
        t = abmodel.modeled_collective_time(
            coll.broadcast_stages(16, nbytes, topo), abmodel.EPIPHANY_NOC)
        print(f"broadcast {nbytes:5d} B -> modeled {t * 1e6:7.2f} us "
              f"({nbytes / t / 1e9:.2f} GB/s effective)")

    # --- 2. train a tiny LM over the same collectives ---------------------
    print("\n== tiny LM trained over shmem collectives ==")
    losses = train_mod.main([
        "--arch", "qwen2-0.5b", "--smoke", "--steps", str(args.steps),
        "--data", "1", "--model", "1", "--seq-len", "64", "--batch", "8",
        "--device", str(device)])
    print("final loss:", losses[-1])
    return losses


if __name__ == "__main__":
    main()
