"""state_device_ms: see ``harness.program_spans.state_device_ms``."""
from harness.program_spans import state_device_ms as read  # noqa: F401
