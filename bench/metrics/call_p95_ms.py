"""call_p95_ms: see ``harness.readings.call_p95_ms``."""
from harness.readings import call_p95_ms as read  # noqa: F401
