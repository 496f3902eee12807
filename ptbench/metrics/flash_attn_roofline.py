"""Kernel 4 (`kernels/ops.py` `attention` -> `csrc/flash_attention.cu`)
against its roofline: the bound time of the attention work that the
prefills of the traced steps need, from the family's `counts` (kept
causal pairs of their true prompts x 2(D + Dv) x Hq, every layer,
against q, k, v and the output moved once; the larger of operations at 989 TFLOP/s and bytes at
3.35 TB/s, call by call), over the kernel's device time in the trace.
Padding to the prompt bucket and keys gathered past the prompt are work
the requests do not need, and do not count."""
from ..peaks import peaks

KERNEL = "flash_fwd_"


def read(win, job):
    peak = peaks(job.device_name)
    if peak is None or not win.trace or win.traced_steps is None:
        return None
    kernel_s = sum(s for name, s in win.trace["kernel_s"].items()
                   if KERNEL in name)
    a, b = win.traced_steps
    rids = [rid for st in win.steps[a:b] for rid in st.admitted]
    if not kernel_s or not rids:
        return None
    lens = {r.rid: len(r.prompt) for r in win.recs}
    layers, C = job.arch["num_hidden_layers"], job.counts
    bound = sum(layers * C.bound_seconds(
        C.attention_flops(job.arch, lens[rid], 1),
        C.attention_bytes(job.arch, lens[rid], 1), peak) for rid in rids)
    return 100.0 * bound / kernel_s
