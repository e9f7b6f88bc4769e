"""Assembler for the VAMPIRE estimation kernels.

:func:`batched_charge_matrix` is the entry point of ``impl='cuda'``: it
runs the plain-torch ``structural_state`` bookkeeping over the padded
batch, the feature kernel once (skipped in distribution mode, where the
expected fractions stand in for the measured data) — together
:func:`charge_planes` — and the per-vendor charge kernel (or its surface
variant) on them, :func:`charge_from_planes`.  The chunked fleet surface
makes the planes once and launches the charge kernel per module chunk."""
from __future__ import annotations

import torch

from repro_torch.core.dram import CommandTrace, LINE_BITS, N_BANKS, \
    N_ROW_BANDS
from repro_torch.core.energy_model import (PowerParams, StructuralState,
                                           masked_cycles, per_trace_fraction,
                                           prev_lines, structural_state,
                                           surface_cycles)
from repro_torch.kernels.vampire_energy.vampire_energy import (
    SCAL_FIELDS, batched_features, vampire_charge, vampire_charge_surface)


def pack_state(st: StructuralState) -> torch.Tensor:
    """One int32 word per command: interleave mode (bits 0-1), background
    state (bits 2-4) and the open-bank mask before the command (bits
    8-15), as the kernels unpack it (``common.cuh``)."""
    weights = 1 << torch.arange(N_BANKS, dtype=torch.int32,
                                device=st.open_before.device)
    mask = (st.open_before.to(torch.int32) * weights).sum(
        dim=-1, dtype=torch.int32)
    return st.il_mode | (st.bg_state << 2) | (mask << 8)


def pack_param_blocks(stacked: PowerParams) -> torch.Tensor:
    """A stacked ``PowerParams`` as the ``(V, 123)`` float32 rows the
    charge kernel loads into shared memory: datadep (24), the scalars in
    ``SCAL_FIELDS`` order (11), open-bank delta, read and write factors
    (3 x 8), act_surface (64)."""
    v = stacked.i2n.shape[0]
    parts = [stacked.datadep.reshape(v, 24),
             torch.stack([getattr(stacked, f) for f in SCAL_FIELDS], dim=-1),
             stacked.bank_open_delta, stacked.bank_read_factor,
             stacked.bank_write_factor, stacked.act_surface.reshape(v, 64)]
    return torch.cat([p.to(torch.float32) for p in parts],
                     dim=-1).contiguous()


def expected_data_features(st: StructuralState, ones_frac, toggle_frac):
    """Distribution mode's per-command ones/toggles from the expected
    fractions (scalars or one per trace); first-access toggles stay 0."""
    t = st.is_rw.shape[0]
    dev = st.is_rw.device
    of = per_trace_fraction(ones_frac, t, dev)[:, None]
    tf = per_trace_fraction(toggle_frac, t, dev)[:, None]
    ones = torch.where(st.is_rw, of * LINE_BITS, 0.0)
    togg = torch.where(st.is_rw & st.has_prev, tf * LINE_BITS, 0.0)
    return ones, togg


def charge_planes(trace: CommandTrace, weight: torch.Tensor, *,
                  ones_frac=None, toggle_frac=None):
    """The trace side of the charge kernels' inputs: the ``structural_state``
    bookkeeping and the feature kernel (skipped in distribution mode) over
    a padded ``(T, N)`` batch -> the eight ``(T, N)`` planes the charge
    kernel reads before the parameter block, or None for a batch of empty
    traces (``N == 0``), which launches nothing.  One set of planes serves
    any number of parameter sets (:func:`charge_from_planes`)."""
    t, n = trace.cmd.shape
    if n == 0:
        return None
    st = structural_state(trace)
    if ones_frac is None:
        tmask = (st.has_prev & st.is_rw).to(torch.float32)
        ones, togg = batched_features(
            trace.data.reshape(t * n, -1),
            prev_lines(trace.data, st).reshape(t * n, -1),
            tmask.reshape(t * n))
        ones, togg = ones.reshape(t, n), togg.reshape(t, n)
    else:
        ones, togg = expected_data_features(st, ones_frac, toggle_frac)
    return (ones.contiguous(), togg.contiguous(), trace.cmd, trace.bank,
            trace.row, trace.dt, pack_state(st),
            weight.to(torch.float32).contiguous())


def charge_from_planes(planes, n_traces: int, stacked: PowerParams, *,
                       surface: bool = False) -> torch.Tensor:
    """The charge kernel (or its surface variant) on :func:`charge_planes`'
    planes for the parameter sets ``stacked`` -> ``(T, V)`` or
    ``(T, V, 8, N_ROW_BANDS)`` masked charge (zeros for empty traces)."""
    v = stacked.i2n.shape[0]
    cells = (N_BANKS, N_ROW_BANDS) if surface else ()
    if planes is None:
        return torch.zeros((n_traces, v) + cells, dtype=torch.float32,
                           device=stacked.i2n.device)
    params = pack_param_blocks(stacked)
    if surface:
        return vampire_charge_surface(*planes, params).reshape(
            (n_traces, v) + cells)
    return vampire_charge(*planes, params)


def batched_charge_matrix(trace: CommandTrace, weight: torch.Tensor,
                          stacked: PowerParams, *, ones_frac=None,
                          toggle_frac=None, surface: bool = False):
    """Masked charge of every (trace, paramset) pair through the kernels
    -> ``((T, V) charge, (T,) masked cycles)``, or with ``surface=True``
    ``((T, V, 8, N_ROW_BANDS) charge, (T, 8, N_ROW_BANDS) cycles)``.
    ``trace``/``weight`` are a padded TraceBatch's ``(T, N)`` fields.
    A batch of empty traces (``N == 0``) launches nothing and gives
    zeros."""
    planes = charge_planes(trace, weight, ones_frac=ones_frac,
                           toggle_frac=toggle_frac)
    charge = charge_from_planes(planes, trace.cmd.shape[0], stacked,
                                surface=surface)
    return charge, (surface_cycles(trace, weight) if surface
                    else masked_cycles(trace, weight))
