"""Small sizes for the CPU tests: a configuration dict of the port's
smoke config and a mix of short requests, run through the same harness
(`run.execute(device="cpu")`)."""
from __future__ import annotations

import sys

from . import ROOT

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

SMOKE_MIX = {"load": "serve_closed_loop", "block": 8, "shared_prefix": 2,
             "prompt": {"dist": "uniform", "min": 4, "max": 12},
             "output": {"dist": "uniform", "min": 3, "max": 6},
             "concurrency": 4,
             "engine": {"max_slots": 4, "prompt_bucket": 16, "max_seq": 24,
                        "page_size": 4},
             "warmup_completions": 4, "check_requests": 1000}


def smoke_arch(cfg) -> dict:
    """The configuration dict (`configs/<name>.json` keys) of a port
    ModelConfig."""
    import torch
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    return {"reference": "dense", "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
            "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": 1e-6,
            "torch_dtype": names[cfg.param_dtype],
            "compute_dtype": names[cfg.dtype]}


def smoke(arch_name: str, **overrides):
    """(port config, configuration dict) of an architecture's smoke size."""
    from repro_torch.configs import smoke_config
    cfg = smoke_config(arch_name, **overrides)
    return cfg, smoke_arch(cfg)
