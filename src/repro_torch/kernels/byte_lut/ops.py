"""Public byte-LUT op: the encoding table of the paper's Section 10.1
applied to cache lines."""
from __future__ import annotations

import torch

from repro_torch.kernels.byte_lut import byte_lut


def apply_lut_lines(lines: torch.Tensor, lut) -> torch.Tensor:
    """Encode ``(..., 16)`` int32 cache lines through a 256-entry byte LUT
    (any integer sequence or tensor, moved to the lines' device)."""
    table = torch.as_tensor(lut).to(lines.device, torch.int32).contiguous()
    flat = byte_lut.apply_lut_lines(lines.reshape(-1, 16).contiguous(),
                                    table)
    return flat.reshape(lines.shape)
