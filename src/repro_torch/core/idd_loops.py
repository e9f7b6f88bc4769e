"""Command-trace generators: JEDEC IDD measurement loops (Section 4) and the
paper's custom characterization microbenchmarks (Sections 5-7, 9.1), as
the port's CPU-tensor traces (field by field the traces of
``repro.core.idd_loops``).

Each generator returns a :class:`CommandTrace` representing the steady-state
loop, already tiled enough times that loop-edge effects are negligible —
mirroring the paper's modified-SoftMC continuous looping (Section 3.1).
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.analysis import trace_lint
from repro_torch.core import dram
from repro_torch.core.dram import (ACT, PRE, PREA, RD, WR, REF, PDE, PDX,
                             PDE_SLOW, SRE, SRX, NOP,
                             CommandTrace, TIMING, line_from_byte,
                             line_with_n_ones, make_trace, tile_trace)

_T = TIMING
DEFAULT_REPS = 64
IDLE_SLOT = 512  # cycles of NOP used for idle loops


def _lints(fn):
    """Run the protocol linter on the generated loop (strict): a JEDEC
    measurement loop that violates the very timings it measures would
    measure the wrong thing.  Generators that return ``(trace, skip)``
    tuples lint the trace element; ``REPRO_TRACE_LINT=off`` disables."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        # CommandTrace is itself a NamedTuple: check for it first, then for
        # the (trace, skip) tuple convention of the sweep-point generators
        trace = out if isinstance(out, CommandTrace) else out[0]
        trace_lint.check_generated(trace, f"idd_loops.{fn.__name__}")
        return out
    return wrapper


def _loop(cmds, banks, rows, cols, datas, dts, reps=DEFAULT_REPS):
    tr = make_trace(cmds, banks, rows, cols,
                    np.stack([np.asarray(d, dtype=np.uint32) for d in datas]),
                    dts)
    return tile_trace(tr, reps)


_Z = np.zeros(dram.LINE_WORDS, dtype=np.uint32)


# ---------------------------------------------------------------------------
# JEDEC IDD loops
# ---------------------------------------------------------------------------
@_lints
def idd2n(reps=4) -> CommandTrace:
    """Idle, all banks precharged."""
    return _loop([PREA, NOP], [0, 0], [0, 0], [0, 0], [_Z, _Z],
                 [_T.tRP, IDLE_SLOT], reps)


@_lints
def idd3n(reps=4) -> CommandTrace:
    """Idle, all banks open (activate all 8 once, then idle).

    The activates are a one-shot setup prefix, not part of the tiled loop
    body: re-issuing ACT to a bank that is already open is protocol-illegal
    (the linter's BANK_ACT_OPEN rule), so only the NOP dwell repeats."""
    setup = make_trace([ACT] * 8, list(range(8)), [0] * 8, [0] * 8,
                       np.stack([_Z] * 8), [_T.tRC] * 8)
    loop = _loop([NOP], [0], [0], [0], [_Z], [IDLE_SLOT * 8], reps)
    return dram.concat_traces(setup, loop)


@_lints
def idd0(reps=DEFAULT_REPS, bank=0, row=0) -> CommandTrace:
    """Repeated ACT/PRE to one bank at tRC."""
    return _loop([ACT, PRE], [bank] * 2, [row] * 2, [0, 0], [_Z, _Z],
                 [_T.tRAS, _T.tRP], reps)


@_lints
def idd1(reps=DEFAULT_REPS, data=None) -> CommandTrace:
    """Repeated ACT/RD/PRE to one bank at tRC (JEDEC pattern 0x00)."""
    d = line_from_byte(0x00) if data is None else data
    return _loop([ACT, RD, PRE], [0] * 3, [0] * 3, [0, 0, 0], [_Z, d, _Z],
                 [_T.tRCD, _T.tRAS - _T.tRCD, _T.tRP], reps)


def _all_banks_open_prefix():
    cmds = [ACT] * 8
    return (cmds, list(range(8)), [0] * 8, [0] * 8, [_Z] * 8, [_T.tRC] * 8)


@_lints
def idd4r(reps=DEFAULT_REPS, data=None) -> CommandTrace:
    """Back-to-back reads across all 8 banks (JEDEC pattern 0x33)."""
    d = line_from_byte(0x33) if data is None else data
    pc, pb, pr, pcol, pd_, pdt = _all_banks_open_prefix()
    cmds, banks, cols, datas, dts = [], [], [], [], []
    for i in range(16):  # two sweeps over banks, alternating column
        cmds.append(RD)
        banks.append(i % 8)
        cols.append(i // 8)
        datas.append(d)
        dts.append(_T.tCCD)
    setup = make_trace(pc, pb, pr, pcol, np.stack(pd_), pdt)
    loop = _loop(cmds, banks, [0] * 16, cols, datas, dts, reps)
    return dram.concat_traces(setup, loop)


@_lints
def idd4w(reps=DEFAULT_REPS, data=None) -> CommandTrace:
    d = line_from_byte(0x33) if data is None else data
    pc, pb, pr, pcol, pd_, pdt = _all_banks_open_prefix()
    cmds, banks, cols, datas, dts = [], [], [], [], []
    for i in range(16):
        cmds.append(WR)
        banks.append(i % 8)
        cols.append(i // 8)
        datas.append(d)
        dts.append(_T.tCCD)
    setup = make_trace(pc, pb, pr, pcol, np.stack(pd_), pdt)
    loop = _loop(cmds, banks, [0] * 16, cols, datas, dts, reps)
    return dram.concat_traces(setup, loop)


@_lints
def idd7(reps=DEFAULT_REPS, data=None) -> CommandTrace:
    """Interleaved {ACT, RD, auto-PRE} across all 8 banks at max rate.

    Each bank's precharge is deferred by two bank slots — it rides as a
    zero-width command just before ACT(b+2), which puts it at ACT(b)+20 and
    clears tRAS=14 (precharging right after the read, at ACT+10, is what
    the linter's tRAS rule flags in the naive schedule).  The final read
    slot is stretched by 4 cycles so the last two banks' wrap-around
    precharges also clear tRAS, giving an 84-cycle steady-state period."""
    d = line_from_byte(0x33) if data is None else data
    cmds, banks, rows, cols, datas, dts = [], [], [], [], [], []
    for b in range(8):
        if b >= 2:
            cmds.append(PRE); banks.append(b - 2); rows.append(0)
            cols.append(0); datas.append(_Z); dts.append(0)
        cmds += [ACT, RD]
        banks += [b] * 2
        rows += [0] * 2
        cols += [0] * 2
        datas += [_Z, d]
        dts += [_T.tRCD, _T.tCCD if b < 7 else _T.tCCD + 4]
    for b in (6, 7):
        cmds.append(PRE); banks.append(b); rows.append(0)
        cols.append(0); datas.append(_Z); dts.append(0)
    return _loop(cmds, banks, rows, cols, datas, dts, reps)


@_lints
def idd5b(reps=16) -> CommandTrace:
    """Continuous refresh bursts (banks already precharged)."""
    return _loop([REF], [0], [0], [0], [_Z], [_T.tRFC], reps)


@_lints
def idd2p1(reps=4) -> CommandTrace:
    """Fast power-down, no banks active."""
    return _loop([PREA, PDE, NOP], [0] * 3, [0] * 3, [0] * 3, [_Z] * 3,
                 [_T.tRP, _T.tCKE, IDLE_SLOT * 4], reps)


@_lints
def idd2p0(reps=4) -> CommandTrace:
    """Slow power-down (DLL off), no banks active."""
    return _loop([PREA, PDE_SLOW, NOP], [0] * 3, [0] * 3, [0] * 3, [_Z] * 3,
                 [_T.tRP, _T.tCKE, IDLE_SLOT * 4], reps)


@_lints
def idd3p(reps=4) -> CommandTrace:
    """Active power-down: bank 0 open at entry, exit through PDX + PREA
    (ACT is illegal during power-down, so the loop must leave the
    power-down state before re-activating on the next repetition)."""
    return _loop([ACT, PDE, NOP, PDX, PREA], [0] * 5, [0] * 5, [0] * 5,
                 [_Z] * 5,
                 [_T.tRCD, _T.tCKE, IDLE_SLOT * 8, _T.tXP, _T.tRP], reps)


@_lints
def idd6(reps=4) -> CommandTrace:
    """Self-refresh: all banks precharged, long dwell, tXS exit."""
    return _loop([PREA, SRE, NOP, SRX], [0] * 4, [0] * 4, [0] * 4, [_Z] * 4,
                 [_T.tRP, _T.tCKE, IDLE_SLOT * 8, _T.tXS], reps)


# NOTE: new keys are appended at the END so existing campaign probe-key
# indices (and hence the seeded measurement-noise stream) stay stable.
IDD_LOOPS = {
    "IDD2N": idd2n, "IDD3N": idd3n, "IDD0": idd0, "IDD1": idd1,
    "IDD4R": idd4r, "IDD4W": idd4w, "IDD7": idd7, "IDD5B": idd5b,
    "IDD2P1": idd2p1,
    "IDD2P0": idd2p0, "IDD3P": idd3p, "IDD6": idd6,
}


# ---------------------------------------------------------------------------
# Section 5.1 — number-of-ones sweeps (single bank, single row, single col)
# ---------------------------------------------------------------------------
@_lints
def ones_sweep_point(n_ones: int, op: int = RD, reps=DEFAULT_REPS,
                     bank=0, row=0) -> CommandTrace:
    d = line_with_n_ones(n_ones)
    setup = make_trace([ACT], [bank], [row], [0], np.stack([_Z]), [_T.tRCD])
    loop = _loop([op] * 4, [bank] * 4, [row] * 4, [0] * 4, [d] * 4,
                 [_T.tCCD] * 4, reps)
    return dram.concat_traces(setup, loop), 2  # skip setup + first access


# ---------------------------------------------------------------------------
# Section 5.2 — interleaving / toggle tests
# ---------------------------------------------------------------------------
@_lints
def interleave_sweep_point(data_a, data_b, il: str, op: int = RD,
                           reps=DEFAULT_REPS) -> CommandTrace:
    """Alternate between two data values with the given interleaving kind:
    'none' (same bank+col), 'col', 'bank', 'bankcol'.

    For 'bankcol' each bank's column must change between its visits (else
    back-to-back accesses classify as plain bank interleaving), so the loop
    touches (b0,c0),(b1,c2),(b0,c1),(b1,c3).
    """
    data_a = np.asarray(data_a, dtype=np.uint32)
    data_b = np.asarray(data_b, dtype=np.uint32)
    if il == "none":
        banks, cols, datas = [0, 0], [0, 0], [data_a, data_a]
    elif il == "col":
        banks, cols, datas = [0, 0], [0, 1], [data_a, data_b]
    elif il == "bank":
        banks, cols, datas = [0, 1], [0, 0], [data_a, data_b]
    elif il == "bankcol":
        banks, cols = [0, 1, 0, 1], [0, 2, 1, 3]
        datas = [data_a, data_b, data_a, data_b]
    else:
        raise ValueError(il)
    n_banks_used = max(banks) + 1
    setup = make_trace([ACT] * n_banks_used, list(range(n_banks_used)),
                       [0] * n_banks_used, [0] * n_banks_used,
                       np.stack([_Z] * n_banks_used), [_T.tRC] * n_banks_used)
    # Pre-touch each (bank, col) once so per-bank last-column state is primed
    # and the steady-state loop classifies with the intended mode.
    prime = make_trace([op] * len(banks), banks, [0] * len(banks), cols,
                       np.stack(datas), [_T.tCCD] * len(banks))
    k = len(banks)
    loop = _loop([op] * (2 * k), banks * 2, [0] * (2 * k), cols * 2,
                 datas * 2, [_T.tCCD] * (2 * k), reps)
    skip = n_banks_used + len(banks)
    return dram.concat_traces(setup, prime, loop), skip


# ---------------------------------------------------------------------------
# Section 6 — structural variation probes
# ---------------------------------------------------------------------------
@_lints
def bank_idle_probe(bank: int, reps=4) -> CommandTrace:
    """One bank open (row 0, all-zero data), idle."""
    setup = make_trace([PREA, ACT], [0, bank], [0, 0], [0, 0],
                       np.stack([_Z, _Z]), [_T.tRP, _T.tRCD])
    loop = _loop([NOP], [bank], [0], [0], [_Z], [IDLE_SLOT * 4], reps)
    return dram.concat_traces(setup, loop), 2


def bank_read_probe(bank: int, op: int = RD, reps=DEFAULT_REPS) -> CommandTrace:
    return ones_sweep_point(0, op=op, reps=reps, bank=bank)


def row_act_probe(row: int, reps=DEFAULT_REPS):
    """IDD0-style ACT/PRE loop on a specific row (Section 6.1.2)."""
    return idd0(reps=reps, row=row), 0


def surface_act_probe(bank: int, row: int, reps=DEFAULT_REPS):
    """ACT/PRE loop on one (bank, row) — the structural-variation surface
    campaign's probe (Section 6 / Figs 19-22): the caller picks rows of
    equal address popcount across row bands, so cell-to-cell current
    differences isolate the per-(bank, row-band) surface factor."""
    return idd0(reps=reps, bank=bank, row=row), 0


@_lints
def column_read_probe(col: int, reps=DEFAULT_REPS) -> CommandTrace:
    d = line_from_byte(0x00)
    setup = make_trace([ACT], [0], [0], [col], np.stack([_Z]), [_T.tRCD])
    loop = _loop([RD] * 4, [0] * 4, [0] * 4, [col] * 4, [d] * 4,
                 [_T.tCCD] * 4, reps)
    return dram.concat_traces(setup, loop), 2


# ---------------------------------------------------------------------------
# Section 9.1 — validation workload {ACT, n x RD, PRE}
# ---------------------------------------------------------------------------
@_lints
def validation_sweep(n_reads: int, reps=8, byte=0xAA) -> CommandTrace:
    d = line_from_byte(byte)
    cmds = [ACT] + [RD] * n_reads + [PRE]
    banks = [0] * (n_reads + 2)
    rows = [128] * (n_reads + 2)
    cols = [0] + [i % 2 for i in range(n_reads)] + [0]
    datas = [_Z] + [d] * n_reads + [_Z]
    dts = ([max(_T.tRCD, _T.tRAS if n_reads == 0 else _T.tRCD)]
           + [_T.tCCD] * n_reads + [_T.tRP])
    # honor tRAS: if reads finish before tRAS, stretch the final read slot
    used = dts[0] + _T.tCCD * max(n_reads - 1, 0)
    if used < _T.tRAS:
        if n_reads:
            dts[n_reads] = dts[n_reads] + (_T.tRAS - used)
        else:
            dts[0] = _T.tRAS
    return _loop(cmds, banks, rows, cols, datas, dts, reps)
