"""Batched multi-trace estimation: the whole ``(traces, vendors)`` report
matrix of a fitted model in one call.

* ragged :class:`CommandTrace` s are NOP/dt=0-padded into one fixed-shape
  :class:`TraceBatch` (a zero-cycle NOP draws no charge and moves no
  integrator state, so padding is exact);
* :func:`batched_reports` / :func:`batched_range_reports` /
  :func:`batched_distribution_reports` / :func:`batched_surface_reports`
  evaluate the four modes with plain PyTorch (``impl='vectorized'``): the
  structural pass runs once over the batch, the charge once per vendor;
* the ``cuda_*`` twins evaluate the same contracts through the
  hand-written kernels (``impl='cuda'``): the feature kernel once per
  batch and the per-vendor charge kernel over ``(chunks, traces, vendors)``;
  their reports, and a chunked map's padding and charges, are spans
  (``repro_torch.spans``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.dram import N_BANKS, N_ROW_BANDS, CommandTrace, \
    batch_traces, check_addresses, pad_trace, stack_traces
from repro_torch.core.energy_model import (EnergyReport, PowerParams,
                                           StructuralFeatures, _report,
                                           charge_from_features,
                                           distribution_features,
                                           extract_structural_features,
                                           finalize_features,
                                           per_trace_fraction, scale_report,
                                           surface_charge, surface_cycles)
from repro_torch.core.fleet import batched_pair_totals
from repro_torch.kernels.common import batch_rows
from repro_torch.spans import span


@dataclasses.dataclass(frozen=True)
class TraceBatch:
    """A fixed-shape batch of command traces (leading trace axis on every
    field) plus the validity mask that excludes padding slots."""
    trace: CommandTrace    # (T, N) on every field
    weight: torch.Tensor   # (T, N) float32: 1 for real commands, 0 for pad

    @classmethod
    def from_traces(cls, traces: Sequence[CommandTrace]) -> "TraceBatch":
        batch, weight = batch_traces([(tr, 0) for tr in traces])
        return cls(batch, weight)

    @property
    def n_traces(self) -> int:
        return self.trace.cmd.shape[0]

    @property
    def device(self) -> torch.device:
        return self.weight.device

    def to(self, device) -> "TraceBatch":
        if self.weight.device == torch.device(device):
            return self
        return TraceBatch(self.trace.to(device), self.weight.to(device))


def as_trace_batch(traces) -> TraceBatch:
    """Accept a prebuilt :class:`TraceBatch`, a single trace, or a sequence
    of (ragged) traces."""
    if isinstance(traces, TraceBatch):
        return traces
    if isinstance(traces, CommandTrace):
        traces = [traces]
    return TraceBatch.from_traces(list(traces))


def bucketed_trace_batch(traces: Sequence[CommandTrace], n_slots: int,
                         length: int) -> TraceBatch:
    """Pad ragged traces into a FIXED ``(n_slots, length)`` batch: the
    command axis NOP/dt=0-pads to ``length`` and whole zero-weight pad rows
    fill the trace axis up to ``n_slots``.  Both paddings are exact.
    Raises ``ValueError`` naming the trace and the command of a bank or
    row out of range."""
    if not traces:
        raise ValueError("bucketed_trace_batch needs at least one trace")
    if len(traces) > n_slots:
        raise ValueError(f"{len(traces)} traces exceed {n_slots} slots")
    longest = max(int(tr.n) for tr in traces)
    if longest > length:
        raise ValueError(f"longest trace ({longest} commands) exceeds the "
                         f"length bucket ({length})")
    stacked = stack_traces([pad_trace(tr, length) for tr in traces])
    check_addresses(stacked)
    dev = stacked.device
    steps = torch.arange(length, device=dev)
    weight = torch.stack([(steps < int(tr.n)).to(torch.float32)
                          for tr in traces])
    pad_rows = n_slots - len(traces)
    if pad_rows:
        stacked = CommandTrace(*(
            torch.cat([x, torch.zeros((pad_rows,) + x.shape[1:],
                                      dtype=x.dtype, device=dev)])
            for x in stacked))
        weight = torch.cat([weight, torch.zeros((pad_rows, length),
                                                dtype=torch.float32,
                                                device=dev)])
    return TraceBatch(stacked, weight)


def original_traces(traces, tb: TraceBatch) -> list[CommandTrace]:
    """The caller's ragged traces when recoverable from the ``estimate``
    argument, else the padded batch rows — exact either way."""
    if isinstance(traces, CommandTrace):
        return [traces]
    if isinstance(traces, (list, tuple)):
        return list(traces)
    return [CommandTrace(*(x[i] for x in tb.trace))
            for i in range(tb.n_traces)]


def _matrix_report(charge, cycles) -> EnergyReport:
    """``_report`` of a ``(T, V[, 8, R])`` charge matrix with per-trace
    cycles broadcast over the vendor axis."""
    return _report(charge, cycles[:, None].expand(charge.shape))


# ---------------------------------------------------------------------------
# The batched dispatches (impl='vectorized')
# ---------------------------------------------------------------------------
def batched_reports(trace: CommandTrace, weight: torch.Tensor,
                    stacked: PowerParams,
                    config: dict | None = None) -> EnergyReport:
    """Energy reports of every (trace, vendor) pair; every leaf is
    ``(traces, vendors)``.  ``config`` places a sharded box in its batch
    (``kernels.common.batch_rows``; as in every dispatch below)."""
    charge, cycles = batched_pair_totals(
        trace, weight, extract_structural_features(trace), stacked, config)
    return _matrix_report(charge, cycles)


def batched_range_reports(trace: CommandTrace, weight: torch.Tensor,
                          stacked: PowerParams, band: torch.Tensor,
                          config: dict | None = None):
    """(lo, mean, hi) report matrices across the per-vendor (V, 2)
    process-variation band."""
    mean = batched_reports(trace, weight, stacked, config)
    return (scale_report(mean, band[None, :, 0]), mean,
            scale_report(mean, band[None, :, 1]))


def batched_distribution_reports(trace: CommandTrace, weight: torch.Tensor,
                                 stacked: PowerParams, ones_frac,
                                 toggle_frac,
                                 config: dict | None = None) -> EnergyReport:
    """No-data-trace mode: expected ones/toggle fractions (scalars or one
    per trace) replace the per-command data features."""
    t = trace.cmd.shape[0]
    dev = trace.device
    of = per_trace_fraction(ones_frac, t, dev)
    tf = per_trace_fraction(toggle_frac, t, dev)
    sf = distribution_features(extract_structural_features(trace), of, tf)
    charge, cycles = batched_pair_totals(trace, weight, sf, stacked, config)
    return _matrix_report(charge, cycles)


def _surface_charges(trace: CommandTrace, weight: torch.Tensor,
                     sf: StructuralFeatures, stacked: PowerParams,
                     rows=None) -> torch.Tensor:
    """Masked surface charge of every (trace, paramset) pair ->
    ``(T, V, 8, R)``; ``sf`` is the batch's structural pass, ``rows``
    the box's place in its batch."""
    charges = []
    for v in range(stacked.i2n.shape[0]):
        pp = stacked.select(v)
        c = charge_from_features(trace, finalize_features(sf, pp), pp)
        charges.append(surface_charge(trace, weight, c, rows))
    return torch.stack(charges, dim=1)


def surface_chunk_charge(trace: CommandTrace, weight: torch.Tensor,
                         stacked: PowerParams, impl: str = "vectorized", *,
                         config: dict | None = None) -> torch.Tensor:
    """The surface charge of every (trace, paramset) pair ->
    ``(T, V, 8, R)``, before its finalisation (:func:`surface_report`):
    plain PyTorch (``'vectorized'``) or the feature and surface charge
    kernels (``'cuda'``, launched at ``config``; ``'vectorized'`` takes
    the box's place in its batch from it).  The one-shot, chunked
    and sharded surface dispatches all reach one of these two, and share
    the finalisation."""
    if impl == "cuda":
        from repro_torch.kernels.vampire_energy import ops as vops
        planes = vops.charge_planes(trace, weight)
        with span("charge", launches=vops.charge_launches):
            return vops.charge_from_planes(planes, trace.cmd.shape[0],
                                           stacked, surface=True,
                                           config=config)
    return _surface_charges(trace, weight,
                            extract_structural_features(trace), stacked,
                            batch_rows(config))


def surface_report(charge: torch.Tensor, trace: CommandTrace,
                   weight: torch.Tensor) -> EnergyReport:
    """The surface report of a ``(T, V, 8, R)`` charge of the batch
    ``trace``/``weight``: the finalisation every surface dispatch
    shares."""
    return _matrix_report(charge, surface_cycles(trace, weight))


def batched_surface_reports(trace: CommandTrace, weight: torch.Tensor,
                            stacked: PowerParams,
                            config: dict | None = None) -> EnergyReport:
    """Per-(bank, row-band) decomposition of every pair: leaves are
    ``(traces, vendors, banks, row_bands)``; summing the cell axes gives
    :func:`batched_reports`."""
    return surface_report(surface_chunk_charge(trace, weight, stacked,
                                               config=config),
                          trace, weight)


# ---------------------------------------------------------------------------
# Memory-bounded surfaces over a module axis of any size
# ---------------------------------------------------------------------------
def _pad_leading(fields, pad: int):
    """Extend every field's leading axis by ``pad`` copies of row 0 (pad
    modules are sliced off before the report; pad traces get weight 0)."""
    if pad == 0:
        return fields
    return type(fields)(*(torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
                          for x in fields))


def chunked_surface_reports(trace: CommandTrace, weight: torch.Tensor,
                            stacked: PowerParams, *, module_chunk: int,
                            trace_chunk: int | None = None,
                            impl: str = "vectorized") -> EnergyReport:
    """``mode='surface'`` over a stacked module axis of any size:
    :func:`batched_surface_reports`' result (``impl='vectorized'``) or
    :func:`cuda_batched_surface_reports`' (``impl='cuda'``), evaluated
    ``module_chunk`` modules (and ``trace_chunk`` traces) at a time.  The
    last chunks are filled with copies of the first module and with
    zero-weight traces, which are sliced off; every (trace, module) pair is
    computed as in the one-shot dispatch, so the result is the same bits."""
    from repro_torch.core import model_api
    impl = model_api.resolve_impl(impl, mode="surface").name
    if impl not in ("vectorized", "cuda"):
        raise ValueError(f"chunked surfaces run impl='vectorized' or "
                         f"'cuda', not {impl!r}")
    n_modules = stacked.i2n.shape[0]
    n_traces = trace.cmd.shape[0]
    module_chunk = min(int(module_chunk), n_modules)
    trace_chunk = (n_traces if trace_chunk is None
                   else min(int(trace_chunk), n_traces))
    m_pad = (-n_modules) % module_chunk
    t_pad = (-n_traces) % trace_chunk
    with span("pack"):
        stacked = _pad_leading(stacked, m_pad)
        padded = _pad_leading(trace, t_pad)
        pad_w = torch.cat([weight,
                           weight.new_zeros((t_pad,) + weight.shape[1:])])
        acc = torch.zeros((n_traces + t_pad, n_modules + m_pad, N_BANKS,
                           N_ROW_BANDS), dtype=torch.float32,
                          device=weight.device)
    for ti in range(0, n_traces + t_pad, trace_chunk):
        rows = slice(ti, ti + trace_chunk)
        tr_c = CommandTrace(*(x[rows] for x in padded))
        w_c = pad_w[rows]
        # the trace side (structural pass, features) once per trace chunk
        if impl == "cuda":
            from repro_torch.kernels.vampire_energy import ops as vops
            planes = vops.charge_planes(tr_c, w_c)
        else:
            sf = extract_structural_features(tr_c)
        for mi in range(0, n_modules + m_pad, module_chunk):
            cols = slice(mi, mi + module_chunk)
            chunk = PowerParams(*(x[cols] for x in stacked))
            if impl != "cuda":
                acc[rows, cols] = _surface_charges(tr_c, w_c, sf, chunk)
                continue
            # the chunk's charge span takes in the scatter
            with span("charge", launches=vops.charge_launches):
                acc[rows, cols] = vops.charge_from_planes(
                    planes, trace_chunk, chunk, surface=True)
    with span("report"):
        return surface_report(acc[:n_traces, :n_modules], trace, weight)


# ---------------------------------------------------------------------------
# The kernel dispatches (impl='cuda')
# ---------------------------------------------------------------------------
def cuda_batched_reports(trace: CommandTrace, weight: torch.Tensor,
                         stacked: PowerParams,
                         config: dict | None = None) -> EnergyReport:
    """impl='cuda' twin of :func:`batched_reports`; ``config`` is the
    charge kernel's launch configuration (as in every twin below)."""
    from repro_torch.kernels.vampire_energy import ops as vops
    charge, cycles = vops.batched_charge_matrix(trace, weight, stacked,
                                                config=config)
    with span("report"):
        return _matrix_report(charge, cycles)


def cuda_batched_range_reports(trace: CommandTrace, weight: torch.Tensor,
                               stacked: PowerParams, band: torch.Tensor,
                               config: dict | None = None):
    """impl='cuda' twin of :func:`batched_range_reports`."""
    mean = cuda_batched_reports(trace, weight, stacked, config)
    return (scale_report(mean, band[None, :, 0]), mean,
            scale_report(mean, band[None, :, 1]))


def cuda_batched_distribution_reports(trace: CommandTrace,
                                      weight: torch.Tensor,
                                      stacked: PowerParams, ones_frac,
                                      toggle_frac,
                                      config: dict | None = None
                                      ) -> EnergyReport:
    """impl='cuda' twin of :func:`batched_distribution_reports` (no
    feature kernel: the expected fractions feed the charge kernel)."""
    from repro_torch.kernels.vampire_energy import ops as vops
    charge, cycles = vops.batched_charge_matrix(
        trace, weight, stacked, ones_frac=ones_frac,
        toggle_frac=toggle_frac, config=config)
    with span("report"):
        return _matrix_report(charge, cycles)


def cuda_batched_surface_reports(trace: CommandTrace, weight: torch.Tensor,
                                 stacked: PowerParams,
                                 config: dict | None = None) -> EnergyReport:
    """impl='cuda' twin of :func:`batched_surface_reports`."""
    charge = surface_chunk_charge(trace, weight, stacked, impl="cuda",
                                  config=config)
    with span("report"):
        return surface_report(charge, trace, weight)
