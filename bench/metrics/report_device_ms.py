"""report_device_ms: see ``harness.program_spans.report_device_ms``."""
from harness.program_spans import report_device_ms as read  # noqa: F401
