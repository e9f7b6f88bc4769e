"""Assembler for the baseline (Micron / DRAMPower) charge kernel: the
per-command structural words from a padded TraceBatch (the state
kernel), then the (vendors, traces, chunks) kernel of one baseline
kind."""
from __future__ import annotations

import torch

from repro_torch.core.dram import ACT, N_BANKS, N_ROW_BANDS, CommandTrace
from repro_torch.core.energy_model import masked_cycles, surface_cycles
from repro_torch.kernels.baseline_energy.baseline_energy import WRAPPERS
from repro_torch.kernels.vampire_energy.vampire_energy import batched_state


def baseline_charge_matrix(trace: CommandTrace, weight, table, kind: str, *,
                           surface: bool = False,
                           config: dict | None = None):
    """Masked charge of every (trace, vendor) pair for one baseline kind
    -> ``((T, V) charge, (T,) masked cycles)``, or with ``surface=True``
    ``((T, V, 8, N_ROW_BANDS) charge, (T, 8, N_ROW_BANDS) cycles)``.
    ``config`` is the kernel's launch configuration
    (``kernels.common.resolve_geometry``)."""
    _, state = batched_state(trace.cmd, trace.bank, trace.col)
    t = trace.cmd.shape[0]
    any_act = (trace.cmd == ACT).any(dim=-1).to(torch.float32)
    charge = WRAPPERS[kind, surface](
        trace.cmd, trace.bank, trace.row, trace.dt, state,
        weight.to(torch.float32).contiguous(), any_act,
        table.to(torch.float32).contiguous(), config=config)
    if surface:
        return (charge.reshape(t, -1, N_BANKS, N_ROW_BANDS),
                surface_cycles(trace, weight))
    return charge, masked_cycles(trace, weight)
