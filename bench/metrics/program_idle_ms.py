"""program_idle_ms: see ``harness.program_spans.program_idle_ms``."""
from harness.program_spans import program_idle_ms as read  # noqa: F401
