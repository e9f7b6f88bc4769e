"""Plain PyTorch version of the byte-LUT kernel.  Lines are int32 bit
patterns; the byte arithmetic widens to int64 so every shift is a logical
one."""
from __future__ import annotations

import torch


def byte_lut(b: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Bytes (any shape, values 0..255) -> ``lut[b]`` as int32."""
    return torch.take(lut.to(torch.int32), b.long())


def words_to_bytes(lines: torch.Tensor) -> torch.Tensor:
    """``(..., 16)`` int32 lines -> ``(..., 64)`` int32 bytes, little-endian
    within each word."""
    w = lines.to(torch.int64) & 0xFFFFFFFF
    parts = [((w >> (8 * i)) & 0xFF) for i in range(4)]
    return torch.stack(parts, dim=-1).reshape(*lines.shape[:-1],
                                              64).to(torch.int32)


def bytes_to_words(b: torch.Tensor) -> torch.Tensor:
    """``(..., 64)`` int32 bytes -> ``(..., 16)`` int32 lines: each word is
    ``b0 | b1 << 8 | b2 << 16 | b3 << 24`` in uint32 arithmetic."""
    b = (b.to(torch.int64) & 0xFFFFFFFF).reshape(*b.shape[:-1], 16, 4)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    w = w & 0xFFFFFFFF
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def apply_lut_lines(lines: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``(N, 16)`` int32 lines -> the lines with every byte replaced by
    ``lut[byte]``."""
    return bytes_to_words(byte_lut(words_to_bytes(lines), lut))
