"""device_ops_per_call: see ``harness.readings.device_ops_per_call``."""
from harness.readings import device_ops_per_call as read  # noqa: F401
