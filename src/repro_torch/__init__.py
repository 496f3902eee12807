"""repro_torch: the PyTorch/CUDA port of `repro`: the paper's OpenSHMEM
runtime on the SIM and SPMD backends (`core/`: patterns, teams, the §3.6
collectives, ShmemContext, the fused reduce-scatter -> AdamW, rank
processes sharing a symmetric heap), the model-serving stack and the
trainer, on one device or a data x model mesh of ranks (`train/`,
`launch/`).

Module names and layout follow `repro` so that each counterpart is easy to
find.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that request they raise.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
