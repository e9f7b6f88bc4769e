"""Assembler for the VAMPIRE estimation kernels.

:func:`batched_charge_matrix` is the entry point of ``impl='cuda'``: it
runs the plain-torch ``structural_state`` bookkeeping over the padded
batch, the feature kernel once (skipped in distribution mode, where the
expected fractions stand in for the measured data) — together
:func:`charge_planes` — and the per-vendor charge kernel (or its surface
variant) on them, :func:`charge_from_planes`.  The chunked fleet surface
makes the planes once and launches the charge kernel per module chunk.
Each step is a span (``repro_torch.spans``): ``state``, ``features``,
``pack``, ``charge`` (opened by the callers of
:func:`charge_from_planes`, so that a chunked map's takes in its
scatter), ``report``."""
from __future__ import annotations

import torch

from repro_torch.core.dram import CommandTrace, LINE_BITS, N_BANKS, \
    N_ROW_BANDS
from repro_torch.core.energy_model import (PowerParams, StructuralState,
                                           masked_cycles, per_trace_fraction,
                                           structural_state, surface_cycles)
from repro_torch.kernels.vampire_energy.vampire_energy import (
    SCAL_FIELDS, batched_features, vampire_charge, vampire_charge_surface)
from repro_torch.spans import span


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
    if trace.cmd.shape[1] == 0:
        return None
    with span("state"):
        st = structural_state(trace)
    if ones_frac is None:
        with span("features"):
            ones, togg = batched_features(trace.data, trace.cmd, st.prev_rw)
    else:
        ones, togg = expected_data_features(st, ones_frac, toggle_frac)
    with span("pack"):
        return (ones.contiguous(), togg.contiguous(), trace.cmd, trace.bank,
                trace.row, trace.dt, pack_state(st),
                weight.to(torch.float32).contiguous())


def charge_launches() -> int:
    """The charge kernels' launches so far (the ``charge`` span's
    ``launches`` count, as ``span("charge", launches=charge_launches)``)."""
    return vampire_charge.launches + vampire_charge_surface.launches


def charge_from_planes(planes, n_traces: int, stacked: PowerParams, *,
                       surface: bool = False,
                       config: dict | None = None) -> torch.Tensor:
    """The charge kernel (or its surface variant) on :func:`charge_planes`'
    planes for the parameter sets ``stacked`` -> ``(T, V)`` or
    ``(T, V, 8, N_ROW_BANDS)`` masked charge (zeros for empty traces).
    ``config`` is the kernel's launch configuration
    (``kernels.common.resolve_geometry``).  The parameter blocks are a
    ``pack`` span; the caller opens the ``charge`` span around the call."""
    v = stacked.i2n.shape[0]
    cells = (N_BANKS, N_ROW_BANDS) if surface else ()
    if planes is None:
        return torch.zeros((n_traces, v) + cells, dtype=torch.float32,
                           device=stacked.i2n.device)
    with span("pack"):
        params = pack_param_blocks(stacked)
    if surface:
        return vampire_charge_surface(*planes, params,
                                      config=config).reshape(
            (n_traces, v) + cells)
    return vampire_charge(*planes, params, config=config)


def batched_charge_matrix(trace: CommandTrace, weight: torch.Tensor,
                          stacked: PowerParams, *, ones_frac=None,
                          toggle_frac=None, surface: bool = False,
                          config: dict | None = None):
    """Masked charge of every (trace, paramset) pair through the kernels
    -> ``((T, V) charge, (T,) masked cycles)``, or with ``surface=True``
    ``((T, V, 8, N_ROW_BANDS) charge, (T, 8, N_ROW_BANDS) cycles)``.
    ``trace``/``weight`` are a padded TraceBatch's ``(T, N)`` fields.
    A batch of empty traces (``N == 0``) launches nothing and gives
    zeros.  ``config`` is the charge kernel's launch configuration."""
    planes = charge_planes(trace, weight, ones_frac=ones_frac,
                           toggle_frac=toggle_frac)
    with span("charge", launches=charge_launches):
        charge = charge_from_planes(planes, trace.cmd.shape[0], stacked,
                                    surface=surface, config=config)
    with span("report"):
        return charge, (surface_cycles(trace, weight) if surface
                        else masked_cycles(trace, weight))
