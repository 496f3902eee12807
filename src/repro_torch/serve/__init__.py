"""serve subsystem: continuous-batching engine on the paged
symmetric-heap KV cache.  The page bookkeeping imports without the model
code; `ServeEngine` and the scheduler live in serve/engine.py."""
from .kv import PagedKV, PagePool, PagePoolError, pages_for  # noqa: F401
