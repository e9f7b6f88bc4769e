"""Plain PyTorch version of the toggle kernel."""
from __future__ import annotations

import torch

from repro_torch.core.dram import line_toggles  # noqa: F401


def line_toggles_seq(lines: torch.Tensor) -> torch.Tensor:
    """Toggles of each line against its predecessor; the first is 0."""
    out = torch.zeros(lines.shape[0], dtype=torch.int32, device=lines.device)
    out[1:] = line_toggles(lines[1:], lines[:-1])
    return out
