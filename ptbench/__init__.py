"""ptbench: the end-to-end benchmark of the PyTorch/CUDA port
(`src/repro_torch/`) on one H100.

One run is ``python3 ptbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout; `BENCHMARK.json` names the
cells.  Each configuration (`configs/<name>.json`), traffic mix
(`traffic/<mix>.json`), cell limit (`cells/<cell>.json`), load
(`loads/<load>.py`), end-to-end metric (`e2e/<metric>.py`),
per-layer metric (`metrics/<metric>.py`) and model family (`ref/<f>.py`
and `counts/<f>.py`, by a configuration's `reference`) is a file of its
own that the harness finds by the name `BENCHMARK.json` or a data file
gives it.
Nothing here imports `jax` or the JAX package `repro`; the plain reference
(`ref/`) imports nothing of the port either.
"""
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
