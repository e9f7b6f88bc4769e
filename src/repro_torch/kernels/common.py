"""Shared kernel plumbing: block arithmetic, padding, the checks every
wrapper makes before a launch, the plain versions' charge reduction, and
the charge kernels' launch geometry."""
from __future__ import annotations

import functools
from dataclasses import dataclass

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


N_CELLS = 64


def cell_index(bank: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """(bank, row-band) cell of every command, as the kernels compute it."""
    return ((bank & 7) << 3) | ((row >> 12) & 7)


CELL_GROUP = 8         # cells one pass of cell_sums compares against


def cell_sums(values: torch.Tensor, cells: torch.Tensor,
              n_cells: int) -> torch.Tensor:
    """Sum ``values`` ``(..., N)`` into ``n_cells`` cells by ``cells``
    (broadcastable to ``values``) -> ``(..., n_cells)``, in the values'
    dtype.  Integers scatter once (exact in any order).  Floats are summed
    per cell by ``sum`` over the command axis, ``CELL_GROUP`` cells a
    pass: a float scatter adds in sequence (a 16k-command cell drifts by
    ~1e-5 in float32) and on the card in the order its atomics land, so
    the same batch could give other bits; a reduction keeps float32
    within the reference's rtol 1e-5 and gives the same bits for the
    same values, wherever pad commands fall."""
    if not values.is_floating_point():
        out = torch.zeros(values.shape[:-1] + (n_cells,), dtype=values.dtype,
                          device=values.device)
        return out.scatter_add_(-1, cells.long().expand(values.shape),
                                values)
    ids = torch.arange(n_cells, dtype=cells.dtype, device=values.device)
    parts = []
    for first in range(0, n_cells, CELL_GROUP):
        hit = cells[..., None, :] == ids[first:first + CELL_GROUP, None]
        parts.append(torch.where(hit, values[..., None, :], 0.0).sum(-1))
    return torch.cat(parts, dim=-1)


def reduce_charge(cw: torch.Tensor, bank, row, surface: bool):
    """``(V, T, N)`` masked charges -> ``(T, V)`` totals, or the
    ``(T, V, 64)`` per-cell sums when ``surface`` (the plain versions'
    reduction, :func:`cell_sums`)."""
    if not surface:
        return cw.sum(dim=-1).T
    return cell_sums(cw, cell_index(bank, row), N_CELLS).transpose(0, 1)


# launch geometry of the charge kernels (csrc/charge.cuh, which also
# lays out and sizes their shared memory)
THREADS = 256          # threads per block; each takes 4 commands a step
MAX_CLUSTER = 8        # blocks per trace: the portable cluster size
MAX_GROUP = 32         # vendors per group, each command read once a group
BLOCKS_PER_SM = 2      # blocks per SM the grid is sized for


@dataclass(frozen=True)
class ChargeGeometry:
    """How a charge kernel covers a ``(T, N)`` batch of ``V`` vendors:
    ``cluster`` blocks (one cluster) per trace, each taking at most
    ``tile`` commands; vendors in ``n_groups`` groups of at most
    ``group``."""
    cluster: int
    group: int
    n_groups: int
    tile: int

    def vendor_groups(self, n_vendors: int) -> list[range]:
        """The vendors each ``blockIdx.y`` computes."""
        return [range(g * self.group, min(n_vendors, (g + 1) * self.group))
                for g in range(self.n_groups)]


@functools.lru_cache(maxsize=1024)
def charge_geometry(n_traces: int, n_cmds: int, n_vendors: int,
                    n_sms: int, blocks_per_sm: int = BLOCKS_PER_SM,
                    max_cluster: int = MAX_CLUSTER) -> ChargeGeometry:
    """The geometry a charge kernel launches with: as few vendor groups
    as ``MAX_GROUP`` allows, of even size, and per trace as many blocks
    (up to ``max_cluster``) as fill ``blocks_per_sm`` blocks on each of
    ``n_sms`` SMs, with the row's steps of ``4 * THREADS`` commands dealt
    to the blocks in turn (a row that does not start on a 16-byte
    boundary may take one step more).  ``blocks_per_sm`` and
    ``max_cluster`` are the autotuner's knobs (``kernels.autotune``)."""
    n_groups = max(1, cdiv(n_vendors, MAX_GROUP))
    group = max(1, cdiv(n_vendors, n_groups))
    row_steps = max(1, cdiv(n_cmds, 4 * THREADS))
    want = max(1, min(max_cluster, cdiv(blocks_per_sm * n_sms,
                                        max(1, n_traces * n_groups))))
    cluster = cdiv(row_steps, cdiv(row_steps, want))
    return ChargeGeometry(cluster=cluster, group=group, n_groups=n_groups,
                          tile=cdiv(row_steps, cluster) * THREADS * 4)


def resolve_geometry(family: str, n_traces: int, n_cmds: int,
                     n_vendors: int, n_sms: int, device_key: str,
                     config: dict | None = None) -> ChargeGeometry:
    """:func:`charge_geometry` at ``config``'s knobs, or, when the caller
    pins none, at the autotuner's choice for the card ``device_key`` and
    the shape's bucket (``autotune.best_config``)."""
    from repro_torch.kernels import autotune
    if config is None:
        config = autotune.best_config(family, n_traces, n_cmds, device_key)
    return charge_geometry(n_traces, n_cmds, n_vendors, n_sms,
                           int(config["blocks_per_sm"]),
                           int(config["max_cluster"]))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _device_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def plane_phase(**planes) -> int:
    """The element offset from a 16-byte boundary that every per-command
    plane shares (the charge kernels load four commands at a time)."""
    phases = {name: (t.data_ptr() // t.element_size()) % 4
              for name, t in planes.items()}
    if len(set(phases.values())) > 1:
        raise ValueError(f"the per-command planes must share one 16-byte "
                         f"alignment, got element offsets {phases}")
    return next(iter(phases.values()), 0)


def launch_charge(fn, pointers: tuple, planes: dict, n_traces: int,
                  n_cmds: int, n_vendors: int, surface: bool,
                  what: str, source: str,
                  config: dict | None = None) -> torch.Tensor:
    """Launch one charge kernel (``fn``, a C entry point of
    ``vampire_energy.cu`` or ``baseline_energy.cu``, whose name is
    ``source``) on ``pointers`` (its input tensors in order) -> its
    ``(T, V)`` or ``(T, V, 64)`` float32 output.  ``config`` pins the
    geometry's knobs; None takes the autotuner's choice for the source's
    mean or surface family."""
    from repro_torch.kernels import build
    dev = next(iter(planes.values())).device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    family = source + ("_surface" if surface else "")
    geo = resolve_geometry(family, n_traces, n_cmds, n_vendors,
                           _sm_count(index), _device_name(index), config)
    shape = (n_traces, n_vendors) + ((N_CELLS,) if surface else ())
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    rc = fn(*(build.ptr(x) for x in pointers), build.ptr(out), n_traces,
            n_cmds, n_vendors, geo.cluster, geo.group,
            plane_phase(**planes), build.stream(dev))
    build.check(rc, what)
    return out
