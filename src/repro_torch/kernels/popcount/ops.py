"""Public popcount op: any leading axes over the ``(N, 16)`` kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.popcount import popcount


def line_ones(lines: torch.Tensor) -> torch.Tensor:
    """``(..., 16)`` int32 lines -> ``(...)`` int32 population count per
    64-byte line."""
    flat = lines.reshape(-1, 16).contiguous()
    return popcount.line_ones(flat).reshape(lines.shape[:-1])
