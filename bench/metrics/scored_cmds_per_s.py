"""scored_cmds_per_s: see ``harness.readings.scored_cmds_per_s``."""
from harness.readings import scored_cmds_per_s as read  # noqa: F401
