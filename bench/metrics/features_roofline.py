"""features_roofline: see ``harness.readings.features_roofline``."""
from harness.readings import features_roofline as read  # noqa: F401
