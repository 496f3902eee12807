"""Finding a cell's files by name: the cell in `BENCHMARK.json`, its
configuration (`configs/<name>.json`), traffic mix (`traffic/<mix>.json`)
and limits (`cells/<cell>.json`), a module of the harness by its kind
and name (`<kind>/<name>.py`: a load, a metric reader, a family's
reference and counts), and the port's `ModelConfig` for the
configuration, held to the file's sizes by the family's reference."""
from __future__ import annotations

import importlib.util
import json
import sys

from . import HERE, ROOT

# the port's ModelConfig fields that hold a torch dtype; a configuration's
# `program.overrides` names them by a string ("bfloat16")
TORCH_DTYPE_FIELDS = ("dtype", "param_dtype", "logit_dtype")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def limits(cell_name: str) -> dict:
    return json.loads((HERE / "cells" / f"{cell_name}.json").read_text())


def module(kind: str, name: str):
    """`ptbench/<kind>/<name>.py`, loaded once by its path (a metric's
    name may hold dots and dashes)."""
    modname = f"ptbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if modname not in sys.modules:
        found = importlib.util.spec_from_file_location(
            modname, HERE / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(found)
        sys.modules[modname] = mod
        found.loader.exec_module(mod)
    return sys.modules[modname]


def family(arch: dict):
    """(reference, counts) of the configuration's family: `ref/<f>.py`
    (`make_weights`, `program_tree`, `check_program`, `logits`) and
    `counts/<f>.py`, for `"reference": "<f>"`."""
    return (module("ref", arch["reference"]),
            module("counts", arch["reference"]))


def program_config(arch: dict):
    """The port's ModelConfig of `arch["program"]["arch"]`, with the
    file's `program.overrides`; raises if it runs other sizes than the
    file states, attention features the reference does not compute, or
    other dtypes than `compute_dtype` and `torch_dtype`."""
    import torch
    from repro_torch.configs import get_config
    prog = arch["program"]
    over = {k: getattr(torch, v) if k in TORCH_DTYPE_FIELDS else v
            for k, v in prog.get("overrides", {}).items()}
    cfg = get_config(prog["arch"], **over)
    family(arch)[0].check_program(cfg, arch)
    if cfg.dtype != getattr(torch, arch["compute_dtype"]) or \
            cfg.param_dtype != getattr(torch, arch["torch_dtype"]):
        raise ValueError(f"{cfg.name}: the port computes in {cfg.dtype} "
                         f"from {cfg.param_dtype} weights, not as the file "
                         "states")
    return cfg
