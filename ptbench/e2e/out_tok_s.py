"""Output tokens that reached their clients inside the window, over the
window's seconds."""
from ..stats import in_window, rate


def read(win, job):
    n = sum(1 for r in win.recs for t in r.times
            if in_window(t, win.t0, win.t1))
    return rate(n, win.t0, win.t1)
