"""The work a request needs, counted from a configuration's sizes and
the traffic's true lengths, never from what an implementation launches:
no prompt bucket, no gathered `max_seq`, no padding.  `dense` holds the
counts of a dense decoder (the configurations' `"reference": "dense"`)."""
