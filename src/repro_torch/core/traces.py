"""Application-level DRAM command traces (paper Sections 9.2 and 10).

Synthetic application traces from a small behavioral model — memory
intensity, row-buffer locality, read/write mix and a byte-value
distribution — with per-app parameters spanning the qualitative range of
the paper's SPEC CPU2006 suite.  A port of the reference's generator: the
same seed gives the same trace, field by field.  The same machinery turns
arbitrary byte buffers (e.g. framework tensors) into traces, and every
producer lints its output (``repro_torch.analysis.trace_lint``).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.core import dram
from repro_torch.core.dram import (ACT, NOP, PDE, PDE_SLOW, PDX, PRE, PREA,
                                   RD, REF, SRX, WR, CommandTrace, TIMING,
                                   LINE_BYTES, LINE_WORDS, N_BANKS,
                                   host_array as _host)

_T = TIMING
_NEG = -(1 << 30)   # "never happened" sentinel time


class TraceBuilder:
    """Emit-order command builder that lands every command on a
    protocol-legal cycle by stretching the *previous* slot's ``dt`` (never
    reordering): the generator states WHAT happens, the builder owns WHEN.

    It tracks the same state the protocol linter
    (``repro_torch.analysis.trace_lint``) checks — per-bank open rows and
    ACT/PRE/RD/WR times, the rolling four-activate window, global
    write-to-read turnaround, and the refresh / power-down-exit lockouts —
    and is a no-op (zero stretched cycles) on schedules that are already
    legal.  Exit lockouts are applied conservatively to every non-NOP
    command (tXPDLL formally binds only RD/WR), which can only lengthen a
    schedule, never break one.

    With ``pad_nop=True`` required lead time rides on an inserted NOP slot
    instead of stretching the previous slot's dt — for rewrites
    (:func:`reschedule_refresh`, the power-down policy) whose contract is
    that the source trace's slot durations are preserved."""

    def __init__(self, pad_nop: bool = False):
        self.pad_nop = pad_nop
        self.cmds: list[int] = []
        self.banks: list[int] = []
        self.rows: list[int] = []
        self.cols: list[int] = []
        self.datas: list = []
        self.dts: list[int] = []
        self.t = 0
        self.stretched = 0                # total cycles added by waits
        self.open_row = [-1] * N_BANKS
        self._act_t = [_NEG] * N_BANKS
        self._close_t = [_NEG] * N_BANKS
        self._wr_t = [_NEG] * N_BANKS
        self._rd_t = [_NEG] * N_BANKS
        self._acts = collections.deque(maxlen=4)
        self._last_act = self._last_wr = self._last_rw = _NEG
        self._busy_until = 0              # tRFC / tXP / tXPDLL / tXS
        self._slow_entry = False

    def _earliest(self, c: int, b: int) -> int:
        t = _NEG
        if c != NOP:
            t = max(t, self._busy_until)
        if c == ACT:
            t = max(t, self._close_t[b] + _T.tRP, self._act_t[b] + _T.tRC,
                    self._last_act + _T.tRRD)
            if len(self._acts) == 4:
                t = max(t, self._acts[0] + _T.tFAW)
        elif c == RD or c == WR:
            t = max(t, self._act_t[b] + _T.tRCD, self._last_rw + _T.tCCD)
            if c == RD:
                t = max(t, self._last_wr + _T.tBURST + _T.tWTR)
        elif c == PRE or c == PREA:
            for tb in (range(N_BANKS) if c == PREA else (b,)):
                if self.open_row[tb] >= 0:
                    t = max(t, self._act_t[tb] + _T.tRAS,
                            self._wr_t[tb] + _T.tBURST + _T.tWR,
                            self._rd_t[tb] + _T.tRTP)
        return t

    def emit(self, c, b=0, r=0, co=0, data=None, dt=0) -> None:
        c, b, r = int(c), int(b), int(r)
        need = self._earliest(c, b)
        if need > self.t:
            self.stretched += need - self.t
            if self.pad_nop or not self.dts:
                self.cmds.append(NOP)
                self.banks.append(0)
                self.rows.append(0)
                self.cols.append(0)
                self.datas.append(None)
                self.dts.append(need - self.t)
            else:
                self.dts[-1] += need - self.t
            self.t = need
        self.cmds.append(c)
        self.banks.append(b)
        self.rows.append(r)
        self.cols.append(int(co))
        self.datas.append(data)
        self.dts.append(int(dt))
        if c == ACT:
            self._act_t[b] = self.t
            self.open_row[b] = r
            self._acts.append(self.t)
            self._last_act = self.t
        elif c == PRE:
            self._close_t[b] = self.t
            self.open_row[b] = -1
        elif c == PREA:
            for tb in range(N_BANKS):
                self._close_t[tb] = self.t
                self.open_row[tb] = -1
        elif c == RD:
            self._rd_t[b] = self.t
            self._last_rw = self.t
        elif c == WR:
            self._wr_t[b] = self.t
            self._last_wr = self.t
            self._last_rw = self.t
        elif c == REF:
            self._busy_until = max(self._busy_until, self.t + _T.tRFC)
        elif c == PDE:
            self._slow_entry = False
        elif c == PDE_SLOW:
            self._slow_entry = True
        elif c == PDX:
            exit_lat = _T.tXPDLL if self._slow_entry else _T.tXP
            self._busy_until = max(self._busy_until, self.t + exit_lat)
        elif c == SRX:
            self._busy_until = max(self._busy_until, self.t + _T.tXS)
        self.t += int(dt)

    def require_open(self, b: int, r: int) -> None:
        """PRE (when another row is open) + ACT so row ``r`` of bank ``b``
        is open — the lazy re-activation every post-refresh / post-window
        access needs."""
        b, r = int(b), int(r)
        if self.open_row[b] == r:
            return
        if self.open_row[b] >= 0:
            self.emit(PRE, b, dt=_T.tRP)
        self.emit(ACT, b, r, dt=_T.tRCD)

    def build(self, origin: str | None = None) -> CommandTrace:
        """Materialize the trace on the CPU (and lint it when ``origin`` is
        given)."""
        n = len(self.cmds)
        data = np.zeros((n, LINE_WORDS), dtype=np.uint32)
        for i, d in enumerate(self.datas):
            if d is not None:
                data[i] = d
        out = dram.make_trace(np.asarray(self.cmds, np.int32),
                              np.asarray(self.banks, np.int32),
                              np.asarray(self.rows, np.int32),
                              np.asarray(self.cols, np.int32), data,
                              dts=np.asarray(self.dts, np.int32))
        if origin is not None:
            from repro_torch.analysis import trace_lint
            trace_lint.check_generated(out, origin)
        return out


# ---------------------------------------------------------------------------
# Byte-value distributions ("what the data looks like")
# ---------------------------------------------------------------------------
def _dist_zeros(rng):
    p = np.full(256, 0.0008)
    p[0x00] = 0.70
    p[0xFF] = 0.05
    p[0x01] = 0.05
    return p / p.sum()


def _dist_ascii(rng):
    p = np.full(256, 0.0004)
    for c in range(0x61, 0x7B):      # lowercase letters
        p[c] = 0.025
    p[0x20] = 0.12                    # space
    for c in range(0x41, 0x5B):
        p[c] = 0.004
    for c in range(0x30, 0x3A):
        p[c] = 0.006
    p[0x0A] = 0.01
    return p / p.sum()


def _dist_int_small(rng):
    # two's-complement integers: many 0x00 high bytes but also many 0xFF
    # sign-extension bytes (8 ones each) — the OWI sweet spot
    p = np.full(256, 0.0008)
    for v, w in ((0x00, 0.32), (0x01, 0.06), (0x02, 0.03), (0x03, 0.02),
                 (0xFF, 0.24), (0xFE, 0.05), (0xFD, 0.02), (0x04, 0.01),
                 (0x08, 0.01), (0x7F, 0.02)):
        p[v] = w
    return p / p.sum()


def _dist_fp32(rng):
    # float exponent bytes cluster at 0x3F/0xBF (6-7 ones) with uniform
    # mantissas
    p = np.full(256, 0.002)
    for v, w in ((0x3F, 0.12), (0xBF, 0.10), (0x40, 0.06), (0xC0, 0.05),
                 (0x3E, 0.05), (0xBE, 0.04), (0x00, 0.08), (0x80, 0.03),
                 (0x7F, 0.03)):
        p[v] = w
    return p / p.sum()


def _dist_pointer(rng):
    # 64-bit heap pointers: 0x00007f.. prefixes -> lots of 0x00 AND 0x7F/0xFF
    p = np.full(256, 0.0015)
    p[0x00] = 0.26
    p[0x7F] = 0.14
    p[0xFF] = 0.06
    p[0x55] = 0.04
    for v in range(0x10, 0x90, 0x08):
        p[v] = 0.01
    return p / p.sum()


def _dist_random(rng):
    return np.full(256, 1.0 / 256)


BYTE_DISTS = {
    "zeros": _dist_zeros, "ascii": _dist_ascii, "int_small": _dist_int_small,
    "fp32": _dist_fp32, "pointer": _dist_pointer, "random": _dist_random,
}


# ---------------------------------------------------------------------------
# Application behavioral model
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AppSpec:
    name: str
    intensity: float      # mean fraction of bus cycles doing data bursts
    row_hit: float        # row-buffer hit probability
    read_frac: float
    data_dist: str
    seed: int = 0


# 23 synthetic applications mirroring the qualitative spread of the paper's
# SPEC CPU2006 suite (memory-bound <-> compute-bound; varied data content).
SPEC_APPS = [
    AppSpec("perlbench",  0.16, 0.75, 0.70, "ascii",     1),
    AppSpec("bzip2",      0.30, 0.55, 0.60, "random",    2),
    AppSpec("gcc",        0.25, 0.65, 0.65, "pointer",   3),
    AppSpec("mcf",        0.75, 0.25, 0.75, "pointer",   4),
    AppSpec("gobmk",      0.12, 0.70, 0.68, "int_small", 5),
    AppSpec("hmmer",      0.22, 0.90, 0.55, "int_small", 6),
    AppSpec("sjeng",      0.10, 0.72, 0.66, "int_small", 7),
    AppSpec("libquantum", 0.82, 0.95, 0.80, "zeros",     8),
    AppSpec("h264ref",    0.26, 0.88, 0.58, "int_small", 9),
    AppSpec("omnetpp",    0.55, 0.30, 0.70, "pointer",  10),
    AppSpec("astar",      0.45, 0.45, 0.72, "pointer",  11),
    AppSpec("xalancbmk",  0.50, 0.40, 0.74, "ascii",    12),
    AppSpec("bwaves",     0.72, 0.90, 0.65, "fp32",     13),
    AppSpec("gamess",     0.08, 0.82, 0.60, "fp32",     14),
    AppSpec("milc",       0.70, 0.82, 0.62, "fp32",     15),
    AppSpec("zeusmp",     0.50, 0.85, 0.61, "fp32",     16),
    AppSpec("gromacs",    0.18, 0.74, 0.63, "fp32",     17),
    AppSpec("cactusADM",  0.62, 0.86, 0.55, "fp32",     18),
    AppSpec("leslie3d",   0.66, 0.86, 0.60, "fp32",     19),
    AppSpec("namd",       0.10, 0.80, 0.64, "fp32",     20),
    AppSpec("soplex",     0.64, 0.35, 0.73, "fp32",     21),
    AppSpec("povray",     0.07, 0.78, 0.62, "fp32",     22),
    AppSpec("lbm",        0.85, 0.93, 0.50, "fp32",     23),
]


def sample_lines(dist_name: str, n_lines: int,
                 rng: np.random.Generator) -> np.ndarray:
    """(n_lines, 16) uint32 lines with bytes drawn from the distribution."""
    p = BYTE_DISTS[dist_name](rng)
    b = rng.choice(256, size=(n_lines, LINE_BYTES), p=p).astype(np.uint32)
    return (b[:, 0::4] | (b[:, 1::4] << 8) | (b[:, 2::4] << 16)
            | (b[:, 3::4] << 24)).astype(np.uint32)


def lines_from_bytes(buf: bytes | np.ndarray) -> np.ndarray:
    """Pack an arbitrary byte buffer into (n_lines, 16) uint32 lines."""
    b = np.frombuffer(bytes(buf), dtype=np.uint8)
    pad = (-len(b)) % LINE_BYTES
    if pad:
        b = np.concatenate([b, np.zeros(pad, dtype=np.uint8)])
    b = b.reshape(-1, LINE_BYTES).astype(np.uint32)
    return (b[:, 0::4] | (b[:, 1::4] << 8) | (b[:, 2::4] << 16)
            | (b[:, 3::4] << 24)).astype(np.uint32)


def app_trace(app: AppSpec, n_requests: int = 2000,
              lines: np.ndarray | None = None) -> CommandTrace:
    """Generate the command trace for one synthetic application.

    Commands are emitted through :class:`TraceBuilder`, so every request
    lands on a protocol-legal cycle (the builder stretches the previous
    slot when a back-to-back random schedule would violate e.g. tWTR or
    tRAS), and the result is linted before it is returned.
    """
    rng = np.random.default_rng(np.random.SeedSequence([29, app.seed]))
    if lines is None:
        lines = sample_lines(app.data_dist, n_requests, rng)
    n_requests = min(n_requests, lines.shape[0])

    bld = TraceBuilder()
    ref_anchor = 0  # builder time when the current refresh interval began
    # gap model: mean bus idle cycles between requests from intensity
    mean_gap = _T.tBURST * (1.0 - app.intensity) / max(app.intensity, 0.01)

    bank_seq = rng.integers(0, N_BANKS, size=n_requests)
    hit_seq = rng.random(n_requests) < app.row_hit
    rd_seq = rng.random(n_requests) < app.read_frac
    row_seq = rng.integers(0, 1 << dram.ROW_BITS, size=n_requests)
    col_seq = rng.integers(0, dram.COLS_PER_ROW, size=n_requests)
    gap_seq = rng.geometric(1.0 / (1.0 + mean_gap), size=n_requests) - 1

    for i in range(n_requests):
        b = int(bank_seq[i])
        if hit_seq[i] and bld.open_row[b] >= 0:
            r = bld.open_row[b]
        else:
            r = int(row_seq[i])
            if bld.open_row[b] >= 0:
                bld.emit(PRE, b, dt=_T.tRP)
            bld.emit(ACT, b, r, dt=_T.tRCD)
        op = RD if rd_seq[i] else WR
        gap = int(gap_seq[i])
        if gap > 128:
            # long idle: finish the burst, precharge, then spend the gap in
            # the deepest low-power state whose exit latency the gap can
            # absorb (fast PDN / slow PDN / self-refresh).  The entry slot
            # bills at the powered-up rate, the dwell rides on a NOP slot,
            # and the exit slot is the last one billed at the low-power
            # rate — the integrator's entry/exit billing semantics.
            if gap > 2048:
                entry, exit_cmd, exit_dt = dram.SRE, dram.SRX, _T.tXS
            elif gap > 512:
                entry, exit_cmd, exit_dt = dram.PDE_SLOW, dram.PDX, \
                    _T.tXPDLL
            else:
                entry, exit_cmd, exit_dt = dram.PDE, dram.PDX, _T.tXP
            bld.emit(op, b, r, int(col_seq[i]), lines[i], dt=_T.tBURST)
            bld.emit(PREA, dt=_T.tRP)
            if (entry != dram.SRE
                    and bld.t - ref_anchor + _T.tCKE + gap + exit_dt
                    >= _T.tREFI):
                # no refresh can be issued inside the power-down window, so
                # when the window would cross the deadline, refresh now
                # (re-stating PREA after keeps the [PREA, entry] adjacency
                # every power-down consumer in the repo expects)
                bld.emit(REF, dt=_T.tRFC)
                bld.emit(PREA, dt=0)
                ref_anchor = bld.t
            bld.emit(entry, dt=_T.tCKE)
            bld.emit(NOP, dt=gap)
            bld.emit(exit_cmd, dt=exit_dt)
            if entry == dram.SRE:
                # self-refresh maintains cell charge internally: the
                # refresh deadline restarts at exit
                ref_anchor = bld.t
            continue
        bld.emit(op, b, r, int(col_seq[i]), lines[i], dt=_T.tBURST + gap)
        if bld.t - ref_anchor >= _T.tREFI:
            # refresh: close all banks, REF, reopen lazily
            bld.emit(PREA, dt=_T.tRP)
            bld.emit(REF, dt=_T.tRFC)
            ref_anchor = bld.t

    return bld.build("traces.app_trace")


def reschedule_refresh(trace: CommandTrace,
                       period: int = _T.tREFI) -> CommandTrace:
    """Re-place the PREA+REF refresh pairs of a trace so every refresh
    interval meets the ``period`` deadline under the trace's *current* dts.

    Trace transforms that stretch command slots (e.g. the encoding LUT
    latency, Section 10.1) push the refreshes ``app_trace`` scheduled past
    the tREFI deadline. This pass rebuilds the schedule with the
    generator's own rule: strip the existing PREA+REF pairs, walk the
    commands counting every slot's dt, refresh after the RD/WR that crosses
    the deadline, and lazily re-ACT banks the moved refresh closed (with a
    PRE first when a different row is open). RD/WR order, data, and slot
    durations are preserved — the :class:`TraceBuilder` walk adds a NOP
    wait slot when an inserted refresh pair needs lead time (e.g. tWR
    before its PREA); traces without REF pass through unchanged.
    """
    cmd = _host(trace.cmd)
    if not (cmd == REF).any():
        return trace
    data = _host(trace.data).astype(np.uint32)
    n = len(cmd)

    keep = np.ones(n, dtype=bool)
    keep[cmd == REF] = False
    prea_before_ref = np.flatnonzero((cmd[:-1] == dram.PREA)
                                     & (cmd[1:] == REF))
    keep[prea_before_ref] = False

    # plain-int working lists: the walk is a Python loop, so per-element
    # numpy scalar access would dominate its cost
    kept = np.flatnonzero(keep)
    cmd_l = cmd[kept].tolist()
    bank_l = _host(trace.bank)[kept].tolist()
    row_l = _host(trace.row)[kept].tolist()
    col_l = _host(trace.col)[kept].tolist()
    dt_l = _host(trace.dt)[kept].tolist()
    data_l = [data[s] for s in kept]

    bld = TraceBuilder(pad_nop=True)
    anchor = 0
    n_kept = len(cmd_l)

    for k in range(n_kept):
        c = cmd_l[k]
        b = bank_l[k]
        r = row_l[k]
        if c == RD or c == WR:
            # the moved refresh may have closed this bank (or left another
            # row open): lazily re-open before replaying the access
            bld.require_open(b, r)
        if c == ACT:
            if bld.open_row[b] == r:
                continue  # bank already open at this row: redundant
            if bld.open_row[b] >= 0:
                bld.emit(PRE, b, dt=_T.tRP)
        if c == PDE or c == PDE_SLOW:
            # no refresh can be issued inside the power-down window: when
            # dwelling through it would cross the deadline, refresh first
            win = dt_l[k]
            j = k + 1
            while j < n_kept:
                win += dt_l[j]
                if cmd_l[j] == PDX:
                    break
                j += 1
            if bld.t - anchor + win >= period:
                if any(o >= 0 for o in bld.open_row):
                    bld.emit(PREA, dt=_T.tRP)
                bld.emit(REF, dt=_T.tRFC)
                # re-state PREA so the [PREA, entry] adjacency every
                # power-down consumer expects survives the inserted REF
                bld.emit(PREA, dt=0)
                anchor = bld.t
        bld.emit(c, b, r, col_l[k], data_l[k], dt_l[k])
        if c == SRX:
            anchor = bld.t  # self-refresh restarted the deadline internally
        if (c == RD or c == WR) and bld.t - anchor >= period:
            bld.emit(PREA, dt=_T.tRP)
            bld.emit(REF, dt=_T.tRFC)
            anchor = bld.t

    return bld.build("traces.reschedule_refresh")


def refresh_deadline_overshoot(trace: CommandTrace,
                               period: int = _T.tREFI) -> int:
    """Worst-case cycles by which any refresh interval of the trace exceeds
    the scheduling deadline (counted exactly as ``app_trace`` counts it: the
    PREA+REF slots start a new interval). <= the final slot's dt when the
    schedule conforms; large when refreshes have drifted."""
    cmd = _host(trace.cmd)
    dt = _host(trace.dt).astype(np.int64)
    worst = 0
    since = 0
    for i in range(len(cmd)):
        if cmd[i] == REF:
            worst = max(worst, since - period)
            since = 0
            continue
        if cmd[i] == dram.SRX:
            since = 0  # self-refresh maintained the cells internally
            continue
        if cmd[i] == dram.PREA and i + 1 < len(cmd) and cmd[i + 1] == REF:
            continue  # the refresh pair's own slots open the next interval
        since += int(dt[i])
    return int(max(worst, since - period))


def trace_request_lines(trace: CommandTrace) -> np.ndarray:
    """The (n_rw, 16) uint32 data lines of the RD/WR commands in a
    trace."""
    cmd = _host(trace.cmd)
    mask = (cmd == RD) | (cmd == WR)
    return _host(trace.data).astype(np.uint32)[mask]
