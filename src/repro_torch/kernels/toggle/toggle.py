"""Wrappers of the bus-toggle kernels (``csrc/line_bits.cu``), which
replace ``line_toggles_pallas``: ``repro_line_toggles`` between two sets
of lines, and ``repro_line_toggles_seq`` between each line and the one
before it.

:func:`line_toggles` and :func:`line_toggles_seq` launch their kernel for
CUDA tensors (and raise on anything it cannot take) and use the plain
versions of ``ref.py`` only for tensors on the CPU.
``line_toggles.launches`` counts the launches of both kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import on_cpu, require_aligned, require_cuda
from repro_torch.kernels.toggle import ref


def line_toggles(cur: torch.Tensor, prev: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """``(N, 16)`` int32 lines ``cur`` and ``prev`` -> ``(N,)`` int32
    ``popcount(cur ^ prev)`` per line, written into ``out`` when given.
    ``cur`` and ``prev`` may be overlapping views of one buffer."""
    n = cur.shape[0]
    if on_cpu(cur, prev):
        counts = ref.line_toggles(cur, prev)
        return counts if out is None else out.copy_(counts)
    if out is None:
        out = torch.empty(n, dtype=torch.int32, device=cur.device)
    dev = require_cuda({"cur": cur, "prev": prev, "out": out},
                       {"cur": torch.int32, "prev": torch.int32,
                        "out": torch.int32},
                       {"cur": (n, 16), "prev": (n, 16), "out": (n,)})
    require_aligned(cur=cur, prev=prev)
    rc = build.library("line_bits").repro_line_toggles(
        build.ptr(cur), build.ptr(prev), build.ptr(out), n,
        build.stream(dev))
    build.check(rc, "line_toggles kernel")
    line_toggles.launches += 1
    return out


line_toggles.launches = 0


def line_toggles_seq(lines: torch.Tensor) -> torch.Tensor:
    """``(N, 16)`` int32 lines -> ``(N,)`` int32 toggles of each line
    against the one before it; the first is 0.  One kernel, which writes
    the first entry too; none for ``N == 0``."""
    if on_cpu(lines):
        return ref.line_toggles_seq(lines)
    n = lines.shape[0]
    dev = require_cuda({"lines": lines}, {"lines": torch.int32},
                       {"lines": (n, 16)})
    require_aligned(lines=lines)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        rc = build.library("line_bits").repro_line_toggles_seq(
            build.ptr(lines), build.ptr(out), n, build.stream(dev))
        build.check(rc, "line_toggles_seq kernel")
        line_toggles.launches += 1
    return out
