"""The device's idle time while the host is inside the model (the
`model.*` and `layer.*` ranges of `transformer.py` `_paged_model` and
`layers.py` `attention_paged`): each idle stretch of the traced window
put down to the innermost program range open at its midpoint
(`ranges.py`), over the traced wall.  With `host_idle_share` it
partitions `idle_share`."""
from ..ranges import idle_split


def read(win, job):
    if not win.trace or "ranges" not in win.trace \
            or win.trace["window_s"] <= 0:
        return None
    return 100.0 * idle_split(win.trace["ranges"])[0] / win.trace["window_s"]
