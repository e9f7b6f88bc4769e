"""bookkeeping_host_ms: see ``harness.program_spans.bookkeeping_host_ms``."""
from harness.program_spans import bookkeeping_host_ms as read  # noqa: F401
