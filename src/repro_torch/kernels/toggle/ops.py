"""Public toggle ops over the ``(N, 16)`` kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.toggle import toggle


def line_toggles(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """``(..., 16)`` int32 lines -> ``(...)`` int32 wires toggling between
    ``prev`` and ``cur``."""
    flat = toggle.line_toggles(cur.reshape(-1, 16).contiguous(),
                               prev.reshape(-1, 16).contiguous())
    return flat.reshape(cur.shape[:-1])


def line_toggles_seq(lines: torch.Tensor) -> torch.Tensor:
    """``(N, 16)`` int32 lines -> ``(N,)`` toggles of each line against its
    predecessor; the first entry is 0.  One kernel reads each line once."""
    return toggle.line_toggles_seq(lines.contiguous())
