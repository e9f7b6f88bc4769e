"""Wrapper of the byte-LUT kernel (``csrc/byte_lut.cu``,
``repro_apply_lut_lines``), which replaces ``byte_lut_pallas``.

:func:`apply_lut_lines` launches the kernel for CUDA tensors (and raises
on anything it cannot take) and uses the plain version of ``ref.py`` only
for tensors on the CPU.  ``apply_lut_lines.launches`` counts the kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.byte_lut import ref
from repro_torch.kernels.common import on_cpu, require_aligned, require_cuda


def apply_lut_lines(lines: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``(N, 16)`` int32 lines and a ``(256,)`` int32 table -> ``(N, 16)``
    int32 lines with every byte replaced by ``lut[byte]``."""
    if on_cpu(lines, lut):
        return ref.apply_lut_lines(lines, lut)
    n = lines.shape[0]
    dev = require_cuda({"lines": lines, "lut": lut},
                       {"lines": torch.int32, "lut": torch.int32},
                       {"lines": (n, 16), "lut": (256,)})
    require_aligned(lines=lines)
    out = torch.empty_like(lines)
    rc = build.library("byte_lut").repro_apply_lut_lines(
        build.ptr(lines), build.ptr(lut), build.ptr(out), n,
        build.stream(dev))
    build.check(rc, "byte_lut kernel")
    apply_lut_lines.launches += 1
    return out


apply_lut_lines.launches = 0
