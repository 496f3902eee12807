"""End-to-end metrics, one file each: `e2e/<name>.py` has `read(win,
job) -> float | None`, from the host clock of the untraced run.  The
harness itself reports `setup_s`."""
