"""Shared kernel plumbing: block arithmetic, padding, the checks every
wrapper makes before a launch, and the partial-sum layout the charge
kernels write."""
from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(x: torch.Tensor, multiple: int, axis: int = 0, value=0):
    """Pad ``axis`` up to a multiple -> (padded, original length)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis), n


def require_cuda(tensors: dict, dtypes: dict, shapes: dict) -> torch.device:
    """Check that every tensor is a contiguous CUDA tensor on one device
    with the dtype and shape the kernel takes; return the device."""
    dev = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            f"{dtypes[name]}")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shapes[name])}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def require_aligned(**tensors) -> None:
    """Check that every tensor starts on a 16-byte boundary (the line
    kernels load 16-byte ``uint4`` vectors)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


# geometry of the charge kernels (common.cuh): commands per block, cells
CHUNK = 1024
N_CELLS = 64


def cell_index(bank: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """(bank, row-band) cell of every command, as the kernels compute it."""
    return ((bank & 7) << 3) | ((row >> 12) & 7)


def reduce_charge(cw: torch.Tensor, bank, row, surface: bool):
    """``(V, T, N)`` masked charges -> ``(T, V)`` totals, or the
    ``(T, V, 64)`` per-cell sums when ``surface`` (the plain versions'
    reduction; cells accumulate in float64, see
    ``energy_model._grouped``)."""
    if not surface:
        return cw.sum(dim=-1).T
    cell = cell_index(bank, row).long().expand(cw.shape)
    out = torch.zeros(cw.shape[:-1] + (N_CELLS,), dtype=torch.float64,
                      device=cw.device)
    out.scatter_add_(-1, cell, cw.to(torch.float64))
    return out.to(cw.dtype).transpose(0, 1)


def partials(n_vendors: int, n_traces: int, n_cmds: int, surface: bool,
             device) -> torch.Tensor:
    """The output a charge kernel writes: one partial per block,
    ``(V, T, chunks)``, or per block and cell, ``(V, T, chunks, 64)``."""
    shape = (n_vendors, n_traces, cdiv(n_cmds, CHUNK))
    if surface:
        shape += (N_CELLS,)
    return torch.empty(shape, dtype=torch.float32, device=device)


def sum_partials(out: torch.Tensor) -> torch.Tensor:
    """Sum a charge kernel's partials over the chunk axis -> ``(T, V)`` or
    ``(T, V, 64)``."""
    return out.sum(dim=2).transpose(0, 1)
