"""setup_s: see ``harness.readings.setup_s``."""
from harness.readings import setup_s as read  # noqa: F401
