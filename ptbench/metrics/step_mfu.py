"""The whole step's share of the chip's bf16 peak: the model operations
that the tokens delivered inside the window need, from the family's
`counts`, over the window's seconds x the peak.  A token from a prefill counts the prefill
of its true prompt; a decoded token its matmuls, attention over its true
context and the LM head.  Nothing the implementation pads or gathers
counts."""
from ..peaks import peaks
from ..stats import in_window


def read(win, job):
    peak = peaks(job.device_name)
    if peak is None:
        return None
    flops, C = 0.0, job.counts
    for r in win.recs:
        lp = len(r.prompt)
        for i, t in enumerate(r.times):
            if in_window(t, win.t0, win.t1):
                flops += C.prefill_flops(job.arch, lp) if i == 0 \
                    else C.token_flops(job.arch, lp + i)
    return 100.0 * flops / ((win.t1 - win.t0) * peak["bf16_flops"])
