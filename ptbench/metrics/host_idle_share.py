"""The device's idle time while the host is in the engine's own phases
(`serve/engine.py`: `serve.schedule`, `serve.batch`, `serve.sample`,
`serve.emit` and the spans around them) or outside the engine (the
harness's client, the profiler): each idle stretch of the traced window
put down to the innermost program range open at its midpoint
(`ranges.py`), over the traced wall.  With `launch_idle_share` it
partitions `idle_share`."""
from ..ranges import idle_split


def read(win, job):
    if not win.trace or "ranges" not in win.trace \
            or win.trace["window_s"] <= 0:
        return None
    return 100.0 * idle_split(win.trace["ranges"])[1] / win.trace["window_s"]
