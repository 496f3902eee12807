"""The engine's decode step (`ServeEngine.step`, its batched
`decode_step_paged` and greedy sampling): the window's decode time over
its decode steps, from `ServeMetrics.on_decode_step`'s walls (each ends
in the host read of the sampled tokens)."""


def read(win, job):
    if not win.decode_walls or not win.decode_walls[1]:
        return None
    total, count = win.decode_walls
    return total / count * 1e3
