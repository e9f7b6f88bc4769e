"""eager_device_ms: see ``harness.readings.eager_device_ms``."""
from harness.readings import eager_device_ms as read  # noqa: F401
