"""The device constants the estimation path reads (a copy of the entries
of ``repro.core.params`` it needs; the port imports nothing of
``repro``)."""
from __future__ import annotations

# Section 5.1: I/O driver current.  During reads the module's I/O drivers
# drive ones on the bus; vendor IDD4R specs EXCLUDE this, the rig measures
# it.  Modelled as a per-driven-one current on the 64 data wires.
IO_DRIVER_MA_PER_ONE_READ = 0.40   # module drives '1's on reads
IO_DRIVER_MA_PER_ZERO_WRITE = 0.39  # module drives '0's on writes
