"""The share of the KV positions that the paged decode gathers
(`layers.py` `paged_kv_gather`: every slot's pages to `max_seq`,
inactive slots included) that belong to a live context: the engine's
tallies `serve.decode.kv_positions_live` over
`serve.decode.kv_positions_read`, taken over the window."""
LIVE, READ = "serve.decode.kv_positions_live", "serve.decode.kv_positions_read"


def read(win, job):
    counts = getattr(win, "program_counts", None) or {}
    if not counts.get(READ):
        return None
    return 100.0 * counts.get(LIVE, 0) / counts[READ]
