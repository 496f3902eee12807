"""Per-layer metrics, one reader each: `metrics/<name>.py` has `read(win,
job) -> float | None`, from the traced run.  A reader that finds nothing
to read returns None, and the metric is left out of the line."""
