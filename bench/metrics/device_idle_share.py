"""device_idle_share: see ``harness.readings.device_idle_share``."""
from harness.readings import device_idle_share as read  # noqa: F401
