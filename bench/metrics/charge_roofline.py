"""charge_roofline: see ``harness.readings.charge_roofline``."""
from harness.readings import charge_roofline as read  # noqa: F401
