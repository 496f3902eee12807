"""Architecture configs of the port.  Each module exposes CONFIG (full
size) and smoke() (a reduced config of the same family for CPU tests)."""
from .registry import ARCHS, get_config, smoke_config  # noqa: F401
