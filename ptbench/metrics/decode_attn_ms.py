"""Paged decode's attention (`models/layers.py` `attention_paged` at one
token a slot: both `paged_kv_update`s and `paged_kv_gather`s, the mask
and `_attend_mq`): the device busy time of the kernels launched under
the `layer.attn.kv` and `layer.attn.core` ranges of the traced
`serve.decode` spans, over their count (`ranges.py`)."""
from ..ranges import leaf

PARTS = ("layer.attn.kv", "layer.attn.core")


def read(win, job):
    ranges = (win.trace or {}).get("ranges")
    if not ranges:
        return None
    steps = sum(v["count"] for p, v in ranges.items()
                if leaf(p) == "serve.decode")
    busy = sum(v["busy_s"] for p, v in ranges.items()
               if leaf(p) in PARTS and "serve.decode" in p.split("/"))
    if not steps or not busy:
        return None
    return busy / steps * 1e3
