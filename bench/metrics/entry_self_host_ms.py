"""entry_self_host_ms: see ``harness.program_spans.entry_self_host_ms``."""
from harness.program_spans import entry_self_host_ms as read  # noqa: F401
