"""Assembler for the VAMPIRE estimation kernels.

:func:`batched_charge_matrix` is the entry point of ``impl='cuda'``: it
runs the state kernel over the padded batch (``structural_state``'s
bookkeeping and :func:`pack_state`'s word), the feature kernel once
(skipped in distribution mode, where the expected fractions stand in for
the measured data) — together :func:`charge_planes` — and the
per-vendor charge kernel (or its surface variant) on them,
:func:`charge_from_planes`.  The chunked fleet surface makes the planes
once and launches the charge kernel per module chunk.  Each step is a
span (``repro_torch.spans``): ``state`` (count ``launches``), ``features``,
``pack``, ``charge`` (opened by the callers of
:func:`charge_from_planes`, so that a chunked map's takes in its
scatter), ``report``."""
from __future__ import annotations

import torch

from repro_torch.core.dram import CommandTrace, LINE_BITS, N_BANKS, \
    N_ROW_BANDS, RD, WR
from repro_torch.core.energy_model import (PowerParams, masked_cycles,
                                           per_trace_fraction,
                                           surface_cycles)
from repro_torch.kernels.vampire_energy.vampire_energy import (  # noqa: F401
    SCAL_FIELDS, batched_features, batched_state, pack_state, vampire_charge,
    vampire_charge_surface)
from repro_torch.spans import span


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


def expected_data_features(cmd: torch.Tensor, prev_rw: torch.Tensor,
                           ones_frac, toggle_frac):
    """Distribution mode's per-command ones/toggles from the expected
    fractions (scalars or one per trace); first-access toggles stay 0.
    ``prev_rw`` is :func:`batched_state`'s."""
    t = cmd.shape[0]
    dev = cmd.device
    of = per_trace_fraction(ones_frac, t, dev)[:, None]
    tf = per_trace_fraction(toggle_frac, t, dev)[:, None]
    is_rw = (cmd == RD) | (cmd == WR)
    ones = torch.where(is_rw, of * LINE_BITS, 0.0)
    togg = torch.where(is_rw & (prev_rw >= 0), tf * LINE_BITS, 0.0)
    return ones, togg


def state_launches() -> int:
    """The state kernel's launches so far (the ``state`` span's
    ``launches`` count)."""
    return batched_state.launches


def charge_planes(trace: CommandTrace, weight: torch.Tensor, *,
                  ones_frac=None, toggle_frac=None):
    """The trace side of the charge kernels' inputs: the state kernel and
    the feature kernel (skipped in distribution mode) over a padded
    ``(T, N)`` batch -> the eight ``(T, N)`` planes the charge kernel
    reads before the parameter block, or None for a batch of empty traces
    (``N == 0``), which launches nothing.  One set of planes serves any
    number of parameter sets (:func:`charge_from_planes`)."""
    if trace.cmd.shape[1] == 0:
        return None
    with span("state", launches=state_launches):
        prev_rw, state = batched_state(trace.cmd, trace.bank, trace.col)
    if ones_frac is None:
        with span("features"):
            ones, togg = batched_features(trace.data, trace.cmd, prev_rw)
    else:
        ones, togg = expected_data_features(trace.cmd, prev_rw, ones_frac,
                                            toggle_frac)
    with span("pack"):
        return (ones.contiguous(), togg.contiguous(), trace.cmd, trace.bank,
                trace.row, trace.dt, state,
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
