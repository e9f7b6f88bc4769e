"""Plain PyTorch version of the popcount kernel: the bit-twiddle popcount
of ``repro_torch.core.dram`` summed per line."""
from __future__ import annotations

from repro_torch.core.dram import line_ones, popcount_u32  # noqa: F401
