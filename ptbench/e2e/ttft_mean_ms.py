"""Mean, over every request submitted inside the window, of the time from
its submission to the end of the step that delivered its first token
(`Window.first_token_waits`; stepped to after the window where it came
late).

A request's first token waits for every prefill admitted in its step,
so the waits fall in groups: one, two, three, four prefills a step.
How many requests each group holds moves with the order of the lengths,
and a percentile near the edge of a group jumps to the next from seed to
seed; the mean moves with the groups' shares and has no edge to jump."""


def read(win, job):
    waits = win.first_token_waits()
    return sum(waits) / len(waits) * 1e3 if waits else None
