"""pack_device_ms: see ``harness.program_spans.pack_device_ms``."""
from harness.program_spans import pack_device_ms as read  # noqa: F401
