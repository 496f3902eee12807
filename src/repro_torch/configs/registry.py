"""--arch <id> registry: the reference's ten architectures."""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = {
    "internlm2-20b": "internlm2_20b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "gemma2-9b": "gemma2_9b",
    "qwen2-0.5b": "qwen2_0_5b",
    "mamba2-2.7b": "mamba2_2_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "hubert-xlarge": "hubert_xlarge",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {list(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str, **overrides):
    cfg = _module(arch).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(arch: str, **overrides):
    cfg = _module(arch).smoke()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
