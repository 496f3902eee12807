"""The share of the prefilled tokens that are prompt (`serve/engine.py`
prefills each request at the prompt bucket): the engine's tallies
`serve.prefill.prompt_tokens` over `serve.prefill.bucket_tokens`, taken
over the window."""
PROMPT, BUCKET = "serve.prefill.prompt_tokens", "serve.prefill.bucket_tokens"


def read(win, job):
    counts = getattr(win, "program_counts", None) or {}
    if not counts.get(BUCKET):
        return None
    return 100.0 * counts.get(PROMPT, 0) / counts[BUCKET]
