"""Loads: how a kind of traffic is offered to the port.  A mix names its
load (`"load"` in `traffic/<mix>.json`); `loads/<load>.py` has
`run(job) -> Window`."""
