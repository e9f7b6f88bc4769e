"""The shared DRAM energy integrator, in PyTorch.

Each command owns a slot of ``dt`` DRAM clock cycles.  During a slot the
module draws the background current of its bank / power state; ``ACT``
adds one activate+precharge pair's charge (scaled by the row-address-ones
factor and the per-(bank, row-band) surface), ``RD``/``WR`` draw the
data-dependent current of paper Eq. 2 for ``tBURST`` cycles (the slot's
background credited back), and ``REF`` adds a fixed charge.  The
background resolves through a five-state lattice (``BG_*``) derived once
per trace with the cumulative-event-index trick that also tracks bank
state.  Charge is in mA x cycles; energy = charge * tCK * VDD.

Every function here takes a SINGLE parameter set and broadcasts over any
leading batch axes of the trace (the command axis is last), so one call
covers a whole ``(traces, commands)`` batch.  Two implementations with
identical semantics:

* the vectorized path (:func:`structural_state` through
  :func:`charge_from_features`);
* :func:`trace_charges_scan` — the command-by-command oracle, a plain
  host-side walk of the state machine.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import dram
from repro_torch.core.dram import (ACT, PRE, PREA, RD, WR, REF, PDE, PDX,
                                   PDE_SLOW, SRE, SRX, IL_NONE, IL_COL,
                                   IL_BANK, IL_BANKCOL, LINE_BITS, N_BANKS,
                                   N_ROW_BANDS, TIMING, TCK_NS, VDD,
                                   CommandTrace, popcount_u32, row_band)
from repro_torch.kernels.common import cell_sums, row_sums

N_SURFACE_CELLS = N_BANKS * N_ROW_BANDS

# the background-state lattice; code 0 is the powered-up state
BG_ACTIVE = 0     # powered up: i2n + open-bank deltas
BG_PDN_FAST = 1   # fast power-down (IDD2P1): i_pd
BG_PDN_SLOW = 2   # slow power-down, DLL off (IDD2P0): i_pd_slow
BG_PDN_ACT = 3    # active power-down, banks open (IDD3P): i_actpd
BG_SR = 4         # self-refresh (IDD6): i_sr


class DataOps(NamedTuple):
    """The two data-stream reductions of the feature pass — per-line
    popcount and bus-XOR toggle count — as injectable callables: the seam
    that isolates the O(N x 512 bit) work from the index bookkeeping.
    :func:`extract_structural_features` takes one, so a feature pass can
    run through the ``kernels/popcount`` / ``kernels/toggle`` kernels
    (:func:`kernel_data_ops`; the parity suite pins it equal to the plain
    default).  The batched ``impl='cuda'`` path does not come through
    here: it fuses both reductions into one kernel over the whole batch
    (``kernels/vampire_energy.batched_features``)."""
    line_ones: object     # (..., 16) int32 -> (...) counts
    line_toggles: object  # ((..., 16), (..., 16)) int32 -> (...) counts


TORCH_DATA_OPS = DataOps(line_ones=dram.line_ones,
                         line_toggles=dram.line_toggles)


def kernel_data_ops() -> DataOps:
    """The kernel-backed :class:`DataOps` (``kernels/popcount`` +
    ``kernels/toggle``), resolved lazily so importing this module never
    pulls in the kernel stack."""
    from repro_torch.kernels.popcount import ops as pc_ops
    from repro_torch.kernels.toggle import ops as tg_ops
    return DataOps(line_ones=pc_ops.line_ones,
                   line_toggles=tg_ops.line_toggles)


class PowerParams(NamedTuple):
    """Everything the integrator needs, as float32 tensors.  The 16 leaves
    keep the reference's order; a stacked set carries a leading vendor
    axis on every leaf."""
    datadep: torch.Tensor            # (4 modes, 2 ops, 3 coeffs) mA
    i2n: torch.Tensor                # () mA background, all banks closed
    bank_open_delta: torch.Tensor    # (8,) mA added per open bank
    bank_read_factor: torch.Tensor   # (8,) multiplicative on read current
    bank_write_factor: torch.Tensor  # (8,)
    q_actpre: torch.Tensor           # () mA*cycles per ACT(+PRE) pair
    row_ones_slope: torch.Tensor     # () fractional ACT charge per row one
    q_ref: torch.Tensor              # () mA*cycles above background per REF
    i_pd: torch.Tensor               # () mA fast power-down
    io_read_ma_per_one: torch.Tensor    # () rig-visible I/O driver current
    io_write_ma_per_zero: torch.Tensor  # ()
    ones_quad: torch.Tensor          # () unmodeled curvature (0 when fitted)
    act_surface: torch.Tensor = torch.ones((N_BANKS, N_ROW_BANDS))
    i_pd_slow: torch.Tensor = torch.tensor(0.0)  # () IDD2P0
    i_actpd: torch.Tensor = torch.tensor(0.0)    # () IDD3P
    i_sr: torch.Tensor = torch.tensor(0.0)       # () IDD6

    @property
    def i3n(self):
        return self.i2n + self.bank_open_delta.sum(-1)

    def to(self, device) -> "PowerParams":
        return PowerParams(*(x.to(device) for x in self))

    def select(self, idx) -> "PowerParams":
        """Rows ``idx`` of every leaf of a stacked set (an int drops the
        vendor axis, a sequence or tensor keeps it)."""
        if not isinstance(idx, int):
            idx = torch.as_tensor(idx, dtype=torch.long,
                                  device=self.i2n.device)
        return PowerParams(*(x[idx] for x in self))


def background_current(pp: PowerParams, bg_state, i_up):
    """The per-state background-current LUT: ``bg_state`` codes gathered
    against the low-power leaves of ``pp``; ``i_up`` is the powered-up
    current (``i2n`` + open-bank deltas)."""
    i_low = torch.where(bg_state == BG_PDN_FAST, pp.i_pd,
                        torch.where(bg_state == BG_PDN_SLOW, pp.i_pd_slow,
                                    torch.where(bg_state == BG_PDN_ACT,
                                                pp.i_actpd, pp.i_sr)))
    return torch.where(bg_state == BG_ACTIVE, i_up, i_low)


class TraceFeatures(NamedTuple):
    """Per-command derived features, including the param-dependent ones."""
    is_rw: torch.Tensor
    op: torch.Tensor
    il_mode: torch.Tensor
    ones: torch.Tensor
    toggles: torch.Tensor
    open_banks: torch.Tensor
    bg_delta_sum: torch.Tensor
    bg_state: torch.Tensor
    row_ones: torch.Tensor


class StructuralFeatures(NamedTuple):
    """The parameter-independent features: everything the trace alone
    determines (computed once, shared by every vendor)."""
    is_rw: torch.Tensor         # (..., N) bool
    op: torch.Tensor            # (..., N) int32: 0 read / 1 write
    il_mode: torch.Tensor       # (..., N) int32 in [0, 4)
    ones: torch.Tensor          # (..., N) int32 (float32 in distribution mode)
    toggles: torch.Tensor       # (..., N) int32 (float32 in distribution mode)
    open_before: torch.Tensor   # (..., N, 8) bool
    bg_state: torch.Tensor      # (..., N) int32 BG_* code
    row_ones: torch.Tensor      # (..., N) int32


class StructuralState(NamedTuple):
    """The index-bookkeeping half of the structural pass: everything but
    the O(N x 512 bit) data reductions.  ``prev_rw`` is the index of the
    previous RD/WR on the bus (-1 if none); :func:`prev_lines` gathers its
    data line."""
    is_rw: torch.Tensor        # (..., N) bool
    op: torch.Tensor           # (..., N) int32
    il_mode: torch.Tensor      # (..., N) int32
    open_before: torch.Tensor  # (..., N, 8) bool
    bg_state: torch.Tensor     # (..., N) int32
    row_ones: torch.Tensor     # (..., N) int32
    prev_rw: torch.Tensor      # (..., N) int32
    has_prev: torch.Tensor     # (..., N) bool


def _exclusive_cummax(x: torch.Tensor) -> torch.Tensor:
    """cummax along the last axis, exclusive (the state *before* each
    element), -1 before the first.  The scan always runs along the
    innermost, contiguous axis: PyTorch's CUDA scan over an outer axis is
    many times slower."""
    c = torch.cummax(x, dim=-1).values
    first = torch.full_like(c[..., :1], -1)
    return torch.cat([first, c[..., :-1]], dim=-1)


def _gather_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[..., index]`` element-wise along the last (command) axis."""
    return torch.gather(x, -1, index.long())


def structural_state(trace: CommandTrace) -> StructuralState:
    """Bank, background and interleave state before each command, over
    every leading batch axis of ``trace`` at once."""
    cmd, bank, col = trace.cmd, trace.bank, trace.col
    n = cmd.shape[-1]
    dev = cmd.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    is_rw = (cmd == RD) | (cmd == WR)
    op = (cmd == WR).to(torch.int32)

    # ---- bank open/closed state before each command --------------------
    # per-bank event planes are laid out (..., 8, N) so every scan runs
    # along the command axis; open_before is handed out as (..., N, 8)
    banks = torch.arange(N_BANKS, device=dev)[:, None]
    bank_oh = bank[..., None, :] == banks                       # (..., 8, N)
    act_ev = (cmd == ACT)[..., None, :] & bank_oh
    pre_ev = (((cmd == PRE)[..., None, :] & bank_oh)
              | (cmd == PREA)[..., None, :])
    last_act = _exclusive_cummax(torch.where(act_ev, idx, -1))
    last_pre = _exclusive_cummax(torch.where(pre_ev, idx, -1))
    open_before = (last_act > last_pre).transpose(-1, -2)      # (..., N, 8)

    # ---- background-state lattice --------------------------------------
    def last(ev):
        return _exclusive_cummax(torch.where(ev, idx, -1))

    last_pdf, last_pds, last_pdx = last(cmd == PDE), last(cmd == PDE_SLOW), \
        last(cmd == PDX)
    last_sre, last_srx = last(cmd == SRE), last(cmd == SRX)
    in_pdn = torch.maximum(last_pdf, last_pds) > last_pdx
    in_sr = last_sre > last_srx
    any_open = open_before.any(dim=-1)
    pd_kind = torch.where(last_pdf >= last_pds,
                          torch.where(any_open, BG_PDN_ACT, BG_PDN_FAST),
                          BG_PDN_SLOW)
    bg_state = torch.where(in_sr, BG_SR,
                           torch.where(in_pdn, pd_kind, BG_ACTIVE)
                           ).to(torch.int32)

    # ---- previous RD/WR on the bus (toggles & interleave mode) ---------
    prev_rw = last(is_rw)
    has_prev = prev_rw >= 0
    prev_rw_c = prev_rw.clamp(min=0)
    prev_bank = torch.where(has_prev, _gather_last(bank, prev_rw_c), -1)

    rw_in_bank = is_rw[..., None, :] & bank_oh
    last_rw_in_bank = _exclusive_cummax(torch.where(rw_in_bank, idx, -1))
    this_bank_last = torch.gather(last_rw_in_bank, -2,
                                  bank[..., None, :].long())[..., 0, :]
    has_bank_prev = this_bank_last >= 0
    prev_col_same_bank = torch.where(
        has_bank_prev, _gather_last(col, this_bank_last.clamp(min=0)), -1)

    same_bank = has_prev & (prev_bank == bank)
    same_col_prev = _gather_last(col, prev_rw_c) == col
    same_col_in_bank = has_bank_prev & (prev_col_same_bank == col)
    il_mode = torch.where(
        ~has_prev, IL_NONE,
        torch.where(same_bank,
                    torch.where(same_col_prev, IL_NONE, IL_COL),
                    torch.where(same_col_in_bank, IL_BANK, IL_BANKCOL))
    ).to(torch.int32)

    row_ones = popcount_u32(trace.row)
    return StructuralState(is_rw, op, il_mode, open_before, bg_state,
                           row_ones, prev_rw, has_prev)


def prev_lines(data: torch.Tensor, st: StructuralState) -> torch.Tensor:
    """(..., N, 16) data line of the previous RD/WR before each command
    (zeros where there is none)."""
    index = st.prev_rw.clamp(min=0).long()[..., None].expand(data.shape)
    prev = torch.gather(data, -2, index)
    return torch.where(st.has_prev[..., None], prev, 0)


def extract_structural_features(trace: CommandTrace,
                                data_ops: DataOps = TORCH_DATA_OPS
                                ) -> StructuralFeatures:
    """The parameter-independent feature pass.  ``data_ops`` injects the
    popcount/toggle reductions: plain torch by default, the kernels with
    :func:`kernel_data_ops`."""
    st = structural_state(trace)
    ones = data_ops.line_ones(trace.data)
    toggles = torch.where(st.has_prev & st.is_rw,
                          data_ops.line_toggles(trace.data,
                                                prev_lines(trace.data, st)),
                          0)
    return StructuralFeatures(st.is_rw, st.op, st.il_mode, ones,
                              toggles.to(torch.int32), st.open_before,
                              st.bg_state, st.row_ones)


def finalize_features(sf: StructuralFeatures,
                      pp: PowerParams) -> TraceFeatures:
    """Attach the parameter-dependent feature: the open-bank background
    delta sum per command."""
    bg_delta_sum = torch.where(sf.open_before, pp.bank_open_delta,
                               0.0).sum(dim=-1)
    open_banks = sf.open_before.to(torch.float32).sum(dim=-1)
    return TraceFeatures(sf.is_rw, sf.op, sf.il_mode, sf.ones, sf.toggles,
                         open_banks, bg_delta_sum, sf.bg_state, sf.row_ones)


def extract_features(trace: CommandTrace, pp: PowerParams) -> TraceFeatures:
    return finalize_features(extract_structural_features(trace), pp)


def per_trace_fraction(frac, n_traces: int, device) -> torch.Tensor:
    """A fraction (a scalar, or one per trace) as a ``(n_traces,)``
    float32 tensor on ``device``.  A scalar is filled on the device and a
    host array copied without waiting on it, so a dispatch on the card
    does not synchronise the host."""
    if isinstance(frac, torch.Tensor):
        return frac.to(device=device, dtype=torch.float32).expand(n_traces)
    a = np.asarray(frac, np.float32)
    if a.ndim == 0:
        return torch.full((n_traces,), float(a), dtype=torch.float32,
                          device=device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device, non_blocking=True).expand(n_traces)


def distribution_features(sf: StructuralFeatures, ones_frac,
                          toggle_frac) -> StructuralFeatures:
    """The no-data-trace mode: expected ones/toggle fractions (scalars or
    one per leading batch row) replace the measured data features; the
    first RD/WR on the bus has no previous burst, so its toggles are 0."""
    dev = sf.is_rw.device
    of = torch.as_tensor(ones_frac, dtype=torch.float32, device=dev)
    tf = torch.as_tensor(toggle_frac, dtype=torch.float32, device=dev)
    if of.ndim:
        of = of[..., None]
    if tf.ndim:
        tf = tf[..., None]
    n = sf.is_rw.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    has_prev = _exclusive_cummax(torch.where(sf.is_rw, idx, -1)) >= 0
    ones = torch.where(sf.is_rw, of * LINE_BITS, 0.0)
    togg = torch.where(sf.is_rw & has_prev, tf * LINE_BITS, 0.0)
    return sf._replace(ones=ones.to(torch.float32),
                       toggles=togg.to(torch.float32))


# ---------------------------------------------------------------------------
# Charge accumulation
# ---------------------------------------------------------------------------
def rw_current(pp: PowerParams, op, il_mode, ones, toggles, bank):
    """Data-dependent RD/WR current (paper Eq. 2) with the structural bank
    factor and the rig-visible I/O driver current."""
    coeffs = pp.datadep[il_mode.long(), op.long()]            # (..., 3)
    onesf = ones.to(torch.float32)
    togf = toggles.to(torch.float32)
    base = coeffs[..., 0] + coeffs[..., 1] * onesf + coeffs[..., 2] * togf
    base = base + pp.ones_quad * coeffs[..., 1] * onesf * (
        onesf / LINE_BITS - 0.5)
    bank = bank.long()
    factor = torch.where(op == 0, pp.bank_read_factor[bank],
                         pp.bank_write_factor[bank])
    io = torch.where(op == 0, pp.io_read_ma_per_one * onesf,
                     pp.io_write_ma_per_zero * (LINE_BITS - onesf))
    return base * factor + io


def integrate_charges(trace: CommandTrace, feats: TraceFeatures,
                      pp: PowerParams, i_rw: torch.Tensor) -> torch.Tensor:
    """Per-command charges (mA*cycles): background over the slot, RD/WR
    burst crediting, ACT (+PRE) and REF charges.  A dt=0 pad slot adds
    exactly zero."""
    dt = trace.dt.to(torch.float32)
    i_bg = background_current(pp, feats.bg_state, pp.i2n + feats.bg_delta_sum)
    charge = i_bg * dt

    burst = torch.clamp(dt, max=float(TIMING.tBURST))
    charge = charge + torch.where(feats.is_rw, (i_rw - i_bg) * burst, 0.0)

    act_q = pp.q_actpre * (1.0 + pp.row_ones_slope
                           * feats.row_ones.to(torch.float32))
    act_q = act_q * pp.act_surface[trace.bank.long(),
                                   row_band(trace.row).long()]
    charge = charge + torch.where(trace.cmd == ACT, act_q, 0.0)
    charge = charge + torch.where(trace.cmd == REF, pp.q_ref, 0.0)
    return charge


def charge_from_features(trace: CommandTrace, feats: TraceFeatures,
                         pp: PowerParams) -> torch.Tensor:
    i_rw = rw_current(pp, feats.op, feats.il_mode, feats.ones, feats.toggles,
                      trace.bank)
    return integrate_charges(trace, feats, pp, i_rw)


def masked_cycles(trace: CommandTrace, weight: torch.Tensor) -> torch.Tensor:
    """Cycles of the commands that count (int32 per leading batch row)."""
    return (trace.dt * weight.to(torch.int32)).sum(dim=-1, dtype=torch.int32)


def masked_totals(trace: CommandTrace, weight: torch.Tensor,
                  charges: torch.Tensor):
    """(masked charge, masked cycles) over the command axis."""
    return row_sums(charges * weight), masked_cycles(trace, weight)


# ---------------------------------------------------------------------------
# The structural-variation surface (mode='surface')
# ---------------------------------------------------------------------------
def surface_cells(trace: CommandTrace) -> torch.Tensor:
    """(..., N) flattened (bank, row-band) cell index of every command."""
    return trace.bank * N_ROW_BANDS + row_band(trace.row)


def _grouped(values: torch.Tensor, cells: torch.Tensor,
             rows=None) -> torch.Tensor:
    """Sum ``values`` (..., N) into their cells -> (..., 8, N_ROW_BANDS)
    (``kernels.common.cell_sums``: float charges stay float32; ``rows``
    places a sharded box in its batch)."""
    return cell_sums(values, cells, N_SURFACE_CELLS, rows).reshape(
        values.shape[:-1] + (N_BANKS, N_ROW_BANDS))


def surface_charge(trace: CommandTrace, weight: torch.Tensor,
                   charges: torch.Tensor, rows=None) -> torch.Tensor:
    """Masked per-command charges grouped onto the structural surface ->
    (..., 8, N_ROW_BANDS) mA*cycles; ``rows`` places a sharded box of
    traces in its batch (``kernels.common.batch_rows``)."""
    return _grouped(charges * weight, surface_cells(trace), rows)


def surface_cycles(trace: CommandTrace, weight: torch.Tensor) -> torch.Tensor:
    """Masked cycles grouped onto the surface -> (..., 8, N_ROW_BANDS)."""
    return _grouped(trace.dt * weight.to(torch.int32), surface_cells(trace))


class EnergyReport(NamedTuple):
    charge_ma_cycles: torch.Tensor
    cycles: torch.Tensor
    avg_current_ma: torch.Tensor
    energy_pj: torch.Tensor   # charge * tCK_ns * VDD  (mA*ns*V == pJ)
    time_ns: torch.Tensor

    def to(self, device) -> "EnergyReport":
        return EnergyReport(*(x.to(device) for x in self))


def _report(total_charge, total_cycles) -> EnergyReport:
    cycles_f = total_cycles.to(torch.float32)
    t_ns = cycles_f * TCK_NS
    avg = total_charge / torch.clamp(cycles_f, min=1.0)
    return EnergyReport(total_charge, total_cycles, avg,
                        total_charge * TCK_NS * VDD, t_ns)


def scale_report(rep: EnergyReport, factor) -> EnergyReport:
    """Scale charge, current and energy by a current factor; the trace's
    duration does not change."""
    return EnergyReport(rep.charge_ma_cycles * factor, rep.cycles,
                        rep.avg_current_ma * factor, rep.energy_pj * factor,
                        rep.time_ns)


def trace_energy_vectorized(trace: CommandTrace,
                            pp: PowerParams) -> EnergyReport:
    charges = charge_from_features(trace, extract_features(trace, pp), pp)
    return _report(row_sums(charges), trace.total_cycles())


def per_command_energy(trace: CommandTrace, pp: PowerParams) -> torch.Tensor:
    """(..., N) per-command energy in pJ (vectorized path)."""
    charges = charge_from_features(trace, extract_features(trace, pp), pp)
    return charges * TCK_NS * VDD


# ---------------------------------------------------------------------------
# The command-by-command oracle (impl='reference')
# ---------------------------------------------------------------------------
def trace_charges_scan(trace: CommandTrace, pp: PowerParams) -> torch.Tensor:
    """(N,) per-command charges of ONE trace from a sequential walk of the
    state machine on the host, in double precision; returned as float32
    on the trace's device."""
    cmds = trace.cmd.tolist()
    banks = trace.bank.tolist()
    rows = trace.row.tolist()
    cols = trace.col.tolist()
    dts = trace.dt.tolist()
    lines = [int.from_bytes(r.tobytes(), "little")
             for r in trace.data.cpu().numpy().astype(np.int32)]
    p = {name: x.tolist() for name, x in zip(PowerParams._fields, pp)}
    lut = {BG_PDN_FAST: p["i_pd"], BG_PDN_SLOW: p["i_pd_slow"],
           BG_PDN_ACT: p["i_actpd"], BG_SR: p["i_sr"]}
    t_burst = float(TIMING.tBURST)

    bank_open = [False] * N_BANKS
    bg_mode = BG_ACTIVE
    prev_line, has_prev, prev_bank = 0, False, -1
    last_col = [-1] * N_BANKS
    out = []
    for c, b, r, co, line, dt in zip(cmds, banks, rows, cols, lines, dts):
        state = (BG_PDN_ACT if bg_mode == BG_PDN_FAST and any(bank_open)
                 else bg_mode)
        if state == BG_ACTIVE:
            i_bg = p["i2n"] + sum(d for d, o in zip(p["bank_open_delta"],
                                                    bank_open) if o)
        else:
            i_bg = lut[state]
        charge = i_bg * dt
        if c in (RD, WR):
            op = 1 if c == WR else 0
            if not has_prev:
                mode = IL_NONE
            elif prev_bank == b:
                mode = IL_NONE if last_col[b] == co else IL_COL
            else:
                mode = IL_BANK if last_col[b] == co else IL_BANKCOL
            ones = float(line.bit_count())
            togg = float((line ^ prev_line).bit_count()) if has_prev else 0.0
            c0, c1, c2 = p["datadep"][mode][op]
            base = c0 + c1 * ones + c2 * togg
            base += p["ones_quad"] * c1 * ones * (ones / LINE_BITS - 0.5)
            if op == 0:
                i_rw = (base * p["bank_read_factor"][b]
                        + p["io_read_ma_per_one"] * ones)
            else:
                i_rw = (base * p["bank_write_factor"][b]
                        + p["io_write_ma_per_zero"] * (LINE_BITS - ones))
            charge += (i_rw - i_bg) * min(float(dt), t_burst)
            prev_line, has_prev, prev_bank = line, True, b
            last_col[b] = co
        elif c == ACT:
            charge += (p["q_actpre"] * (1.0 + p["row_ones_slope"]
                                        * r.bit_count())
                       * p["act_surface"][b][row_band(r)])
            bank_open[b] = True
        elif c == REF:
            charge += p["q_ref"]
        elif c == PRE:
            bank_open[b] = False
        elif c == PREA:
            bank_open = [False] * N_BANKS
        elif c == PDE:
            bg_mode = BG_PDN_FAST
        elif c == PDE_SLOW:
            bg_mode = BG_PDN_SLOW
        elif c == SRE:
            bg_mode = BG_SR
        elif c in (PDX, SRX):
            bg_mode = BG_ACTIVE
        out.append(charge)
    return torch.tensor(out, dtype=torch.float32, device=trace.device)


def trace_energy_scan(trace: CommandTrace, pp: PowerParams) -> EnergyReport:
    charges = trace_charges_scan(trace, pp)
    return _report(charges.sum(), trace.total_cycles())
