"""95th percentile of every inter-token gap of every request that ends
inside the window (`Window.token_gaps`): from the step end that delivered
one token to the step end that delivered the next (a gap that holds a
prefill counts; two tokens of one step are a gap of 0)."""
from ..stats import percentile


def read(win, job):
    p = percentile(win.token_gaps(), 95)
    return None if p is None else p * 1e3
