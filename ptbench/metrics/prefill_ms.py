"""The engine's admission prefill: the `serve.prefill` spans of the
engine's `Tracer` inside the window (each waits for the card as it opens
and closes), their time over their count."""


def read(win, job):
    if not win.prefill_walls:
        return None
    return sum(win.prefill_walls) / len(win.prefill_walls) * 1e3
