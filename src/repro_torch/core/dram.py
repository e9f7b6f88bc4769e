"""DRAM geometry, commands, timing and the command-trace container.

The device class is the paper's: DDR3L-800 SO-DIMMs, one rank, 8 banks,
64-byte cache lines (512 bits), VDD = 1.35 V.  A :class:`CommandTrace` is
a NamedTuple of tensors; every field may carry leading batch axes, the
command axis is always the last axis of ``cmd``/``bank``/``row``/``col``/
``dt`` and the second-to-last of ``data``.

Data lines are held as **int32 bit patterns** (16 words of a 64-byte
line): PyTorch on the CPU has no shifts, adds or compares on
``torch.uint32``, so the plain popcount below widens to int64 and the
CUDA kernels reinterpret the same bits as ``uint32_t``.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Device constants (DDR3L-800, Table 1 of the paper)
# ---------------------------------------------------------------------------
VDD = 1.35                  # volts (DDR3L nominal)
N_BANKS = 8
LINE_BYTES = 64             # one cache line per RD/WR across the rank
LINE_BITS = LINE_BYTES * 8  # 512
LINE_WORDS = LINE_BYTES // 4  # 16 32-bit words
ROW_BITS = 15               # 32k rows per bank
COLS_PER_ROW = 128          # 128 cache lines per 8 kB row
# structural-variation surface: rows grouped into 8 contiguous bands
N_ROW_BANDS = 8
ROW_BAND_SHIFT = ROW_BITS - 3   # row >> 12 -> band in [0, 8)
MT_PER_S = 800e6
CLOCK_HZ = MT_PER_S / 2     # 400 MHz DRAM clock
TCK_NS = 1e9 / CLOCK_HZ     # 2.5 ns


class Timing(NamedTuple):
    """DDR3L-800 timing parameters, in DRAM clock cycles (tCK = 2.5 ns).
    Field order matches the reference's ``Timing``."""
    tRCD: int = 6
    tRP: int = 6
    tRAS: int = 14
    tRC: int = 20
    tCCD: int = 4
    tBURST: int = 4
    tRFC: int = 64
    tREFI: int = 3120
    tWR: int = 6
    tRTP: int = 4
    tCKE: int = 3
    tXP: int = 5
    tXPDLL: int = 24
    tXS: int = 74
    tRRD: int = 4
    tFAW: int = 16
    tWTR: int = 4


TIMING = Timing()

# ---------------------------------------------------------------------------
# Commands and interleave modes
# ---------------------------------------------------------------------------
NOP = 0
ACT = 1
PRE = 2
RD = 3
WR = 4
REF = 5
PDE = 6        # fast power-down entry (active power-down if banks open)
PDX = 7        # power-down exit
PREA = 8       # precharge all banks
PDE_SLOW = 9   # slow (precharge) power-down entry, DLL off
SRE = 10       # self-refresh entry
SRX = 11       # self-refresh exit

CMD_NAMES = {NOP: "NOP", ACT: "ACT", PRE: "PRE", RD: "RD", WR: "WR",
             REF: "REF", PDE: "PDE", PDX: "PDX", PREA: "PREA",
             PDE_SLOW: "PDE_SLOW", SRE: "SRE", SRX: "SRX"}

IL_NONE = 0      # same bank & same column as previous RD/WR
IL_COL = 1       # same bank, different column
IL_BANK = 2      # different bank, same column as that bank's last access
IL_BANKCOL = 3   # different bank, different column


class CommandTrace(NamedTuple):
    """A DRAM command trace as a structure of tensors.

    ``dt`` is the number of DRAM clock cycles this command owns (issue slot
    to the next command's issue slot); a trace lasts ``sum(dt)`` cycles."""
    cmd: torch.Tensor    # (..., N) int32 command codes
    bank: torch.Tensor   # (..., N) int32 in [0, 8)
    row: torch.Tensor    # (..., N) int32 in [0, 2^15)
    col: torch.Tensor    # (..., N) int32 in [0, 128)
    data: torch.Tensor   # (..., N, 16) int32 bit patterns of the line
    dt: torch.Tensor     # (..., N) int32 cycles

    @property
    def n(self) -> int:
        return self.cmd.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.cmd.device

    def to(self, device) -> "CommandTrace":
        return CommandTrace(*(f.to(device) for f in self))

    def total_cycles(self) -> torch.Tensor:
        return self.dt.sum(dim=-1, dtype=torch.int32)


# commands illegal while in power-down / outside NOP+SRX in self-refresh
_PDN_ILLEGAL = (ACT, RD, WR, REF, SRE)
_SR_LEGAL = (NOP, SRX)


def validate_low_power_transitions(cmds) -> None:
    """Raise ``ValueError`` on commands issued inside a low-power state
    that the device cannot accept (e.g. ``ACT`` during self-refresh)."""
    cmd = np.asarray(cmds).reshape(-1)
    if not np.isin(cmd, (PDE, PDE_SLOW, SRE)).any():
        return
    in_pdn = in_sr = False
    for i, c in enumerate(cmd.tolist()):
        if in_sr and c not in _SR_LEGAL:
            raise ValueError(
                f"illegal command {CMD_NAMES.get(c, c)} at index {i}: "
                f"only NOP/SRX are legal during self-refresh")
        if in_pdn and c in _PDN_ILLEGAL:
            raise ValueError(
                f"illegal command {CMD_NAMES.get(c, c)} at index {i}: "
                f"not legal during power-down (exit with PDX first)")
        if c in (PDE, PDE_SLOW):
            in_pdn = True
        elif c == PDX:
            in_pdn = False
        elif c == SRE:
            in_sr = True
        elif c == SRX:
            in_sr = False


def check_addresses(trace: CommandTrace) -> None:
    """Raise ``ValueError`` for the first command whose bank lies outside
    [0, ``N_BANKS``) or whose row lies outside [0, 2**``ROW_BITS``),
    naming the trace (its row of a ``(T, N)`` batch; 0 for one trace) and
    the command."""
    bank, row = trace.bank, trace.row
    bad = (bank < 0) | (bank >= N_BANKS) | (row < 0) | (row >= 1 << ROW_BITS)
    if not bool(bad.any()):
        return
    n = bad.shape[-1]
    t, i = torch.nonzero(bad.reshape(-1, n))[0].tolist()
    b, r = int(bank.reshape(-1, n)[t, i]), int(row.reshape(-1, n)[t, i])
    what = (f"bank {b} outside [0, {N_BANKS})" if not 0 <= b < N_BANKS
            else f"row {r} outside [0, {1 << ROW_BITS})")
    raise ValueError(f"trace {t}, command {i}: {what}")


def host_array(x) -> np.ndarray:
    """A tensor (on any device), array or list as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def lines_as_int32(data) -> torch.Tensor:
    """64-byte lines (uint32 words from numpy/lists, or an int32 tensor)
    as an int32 bit-pattern tensor."""
    if isinstance(data, torch.Tensor):
        if data.dtype == torch.int32:
            return data
        return torch.from_numpy(
            data.cpu().numpy().astype(np.uint32).view(np.int32))
    arr = np.asarray(data)
    if arr.dtype.kind == "i":
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr.astype(np.uint32).view(np.int32))


def make_trace(cmds, banks=None, rows=None, cols=None, data=None, dts=None,
               default_dt: int = 1) -> CommandTrace:
    """Build a CommandTrace of CPU tensors from (list, numpy or tensor)
    fields; the low-power transition rules and the bank and row ranges
    (:func:`check_addresses`) are checked.  Estimators move traces
    to their own device.

    The full protocol linter (``repro_torch.analysis.trace_lint``)
    additionally runs on every construction when ``REPRO_TRACE_LINT`` is
    set to ``warn`` or ``strict``; it is off by default here because unit
    tests legitimately build toy traces with symbolic 1-cycle slots.  The
    generators lint their outputs unconditionally."""
    validate_low_power_transitions(host_array(cmds))

    def i32(x):
        if isinstance(x, torch.Tensor):
            return x.to("cpu", torch.int32)
        return torch.tensor(np.asarray(x), dtype=torch.int32)

    cmd = i32(cmds)
    n = cmd.shape[0]
    z = torch.zeros(n, dtype=torch.int32)
    bank = z if banks is None else i32(banks)
    row = z if rows is None else i32(rows)
    col = z if cols is None else i32(cols)
    if data is None:
        dat = torch.zeros((n, LINE_WORDS), dtype=torch.int32)
    else:
        dat = lines_as_int32(data)
        if dat.ndim == 1:
            dat = dat[None, :].expand(n, LINE_WORDS).contiguous()
    dt = (torch.full((n,), default_dt, dtype=torch.int32) if dts is None
          else i32(dts))
    trace = CommandTrace(cmd, bank, row, col, dat, dt)
    check_addresses(trace)
    mode = os.environ.get("REPRO_TRACE_LINT", "off")
    if mode != "off":
        from repro_torch.analysis import trace_lint
        trace_lint.check_trace(trace, origin="make_trace", mode=mode)
    return trace


def pad_trace(trace: CommandTrace, length: int) -> CommandTrace:
    """NOP-pad a trace to ``length`` commands with ``dt == 0`` slots: a NOP
    owning zero cycles draws zero charge and moves no integrator state."""
    n = trace.n
    if length < n:
        raise ValueError(f"cannot pad a {n}-command trace to {length}")
    pad = length - n
    if pad == 0:
        return trace
    dev = trace.device
    zi = torch.zeros(pad, dtype=torch.int32, device=dev)  # NOP == 0
    return CommandTrace(
        torch.cat([trace.cmd, zi]), torch.cat([trace.bank, zi]),
        torch.cat([trace.row, zi]), torch.cat([trace.col, zi]),
        torch.cat([trace.data, torch.zeros((pad, LINE_WORDS),
                                           dtype=torch.int32, device=dev)]),
        torch.cat([trace.dt, zi]))


def concat_traces(*traces: CommandTrace) -> CommandTrace:
    """Commands of several traces, one after the other."""
    return CommandTrace(*(torch.cat(f) for f in zip(*traces)))


def tile_trace(trace: CommandTrace, reps: int) -> CommandTrace:
    """Repeat a command loop ``reps`` times (the paper's
    loop-until-measured)."""
    return CommandTrace(*(x.repeat((reps,) + (1,) * (x.ndim - 1))
                          for x in trace))


def stack_traces(traces) -> CommandTrace:
    """Stack equal-length traces along a new leading axis."""
    return CommandTrace(*(torch.stack(f) for f in zip(*traces)))


def batch_traces(traces_and_skips) -> tuple[CommandTrace, torch.Tensor]:
    """Stack variable-length traces into one fixed-shape batch.

    ``traces_and_skips`` is a sequence of ``(trace, skip)`` pairs: the
    first ``skip`` commands and all padding are masked out.  Returns
    ``(batch, weight)`` with a leading probe axis on every field and a
    float32 ``(P, N)`` weight.  Raises ``ValueError`` naming the trace
    and the command of a bank or row out of range."""
    pairs = list(traces_and_skips)
    length = max(tr.n for tr, _ in pairs)
    batch = stack_traces([pad_trace(tr, length) for tr, _ in pairs])
    check_addresses(batch)
    idx = np.arange(length)
    weight = np.stack([(idx >= skip) & (idx < tr.n)
                       for tr, skip in pairs]).astype(np.float32)
    return batch, torch.from_numpy(weight).to(batch.device)


# ---------------------------------------------------------------------------
# Data-pattern helpers
# ---------------------------------------------------------------------------
def line_from_byte(byte_value: int) -> np.ndarray:
    """64-byte line where every byte equals ``byte_value`` (JEDEC style),
    as 16 uint32 words."""
    b = byte_value & 0xFF
    w = b | (b << 8) | (b << 16) | (b << 24)
    return np.full(LINE_WORDS, w, dtype=np.uint32)


def line_with_n_ones(n_ones: int,
                     rng: np.random.Generator | None = None) -> np.ndarray:
    """A 512-bit line with exactly ``n_ones`` ones (the low bits first, or
    at ``rng``'s random positions), as 16 uint32 words."""
    if not 0 <= n_ones <= LINE_BITS:
        raise ValueError(f"n_ones {n_ones} outside [0, {LINE_BITS}]")
    bits = np.zeros(LINE_BITS, dtype=np.uint8)
    if rng is None:
        bits[:n_ones] = 1
    else:
        bits[rng.choice(LINE_BITS, size=n_ones, replace=False)] = 1
    return pack_bits(bits)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """512 bits (bit i of word w is ``bits[32 * w + i]``) -> 16 uint32
    words."""
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = (bits.reshape(LINE_WORDS, 32).astype(np.uint64) * weights).sum(
        axis=1)
    return words.astype(np.uint32)


def row_band(row):
    """Row-band index of a row address (int, numpy or tensor)."""
    return row >> ROW_BAND_SHIFT


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of 32-bit words held as int32 bit
    patterns (or any integer tensor; only the low 32 bits count), done in
    int64 so every shift is a logical one.  Returns int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def line_ones(data: torch.Tensor) -> torch.Tensor:
    """Number of ones per 64-byte line: (..., 16) -> (...) int32."""
    return popcount_u32(data).sum(dim=-1, dtype=torch.int32)


def line_toggles(data: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Number of bus wires that toggle between two consecutive lines."""
    return line_ones(torch.bitwise_xor(data, prev))
