"""Which gradient leaves the data-axis sync must reduce (the part of
`repro/parallel/sharding.py` the one-device trainer reads).

Without fsdp and without expert parallelism over `data` (neither is
ported), every leaf of the dense family is replicated over `data`, so
every gradient leaf is synced."""
from __future__ import annotations

from ..models.config import ModelConfig
from ..models.transformer import map_params


def needs_data_sync(cfg: ModelConfig, params):
    """Bool tree of `params`' structure: True where the gradient leaf is
    replicated over `data` and needs grad_sync (every leaf here)."""
    return map_params(lambda _: True, params)
