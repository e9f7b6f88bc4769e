"""call_mfu: see ``harness.readings.call_mfu``."""
from harness.readings import call_mfu as read  # noqa: F401
