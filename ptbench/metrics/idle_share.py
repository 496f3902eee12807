"""The device's idle share over the traced window: 1 - busy / wall, the
busy time the union of every operation the profiler saw on the card."""


def read(win, job):
    if not win.trace or win.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - win.trace["busy_s"] / win.trace["window_s"])
