"""host_enqueue_ms: see ``harness.readings.host_enqueue_ms``."""
from harness.readings import host_enqueue_ms as read  # noqa: F401
