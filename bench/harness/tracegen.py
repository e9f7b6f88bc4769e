"""The benchmark's frozen trace generator, in numpy.

A copy of ``repro_torch/core/traces.py``'s ``TraceBuilder``, byte-value
distributions, ``AppSpec``/``SPEC_APPS`` and ``app_trace`` (origin:
commit 3b119a0), with three changes: the random stream is seeded from an
``entropy`` tuple the caller gives (the port seeds from ``(29,
app.seed)``; passing that tuple gives the port's commands), the trace is
returned as numpy arrays rather than tensors, and it is not linted.  The
timing and geometry come from the configuration file
(``configs/<config>.json`` ``dram``), not from the program.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

# command codes (repro_torch/core/dram.py)
NOP, ACT, PRE, RD, WR, REF, PDE, PDX, PREA, PDE_SLOW, SRE, SRX = range(12)

_NEG = -(1 << 30)   # "never happened" sentinel time


@dataclasses.dataclass(frozen=True)
class Dram:
    """Geometry and timing (DRAM clock cycles) of the modelled module."""
    n_banks: int
    row_bits: int
    cols_per_row: int
    line_bytes: int
    tck_ns: float
    vdd: float
    timing: dict

    @classmethod
    def from_config(cls, cfg: dict) -> "Dram":
        d = cfg["dram"]
        return cls(int(d["banks"]), int(d["row_bits"]),
                   int(d["cols_per_row"]), int(d["line_bytes"]),
                   float(d["tck_ns"]), float(d["vdd"]),
                   {k: int(v) for k, v in d["timing"].items()})

    @property
    def line_words(self) -> int:
        return self.line_bytes // 4


class TraceBuilder:
    """Emit-order command builder that lands every command on a
    protocol-legal cycle by stretching the previous slot's ``dt``."""

    def __init__(self, dram: Dram):
        t = dram.timing
        self.T = t
        self.nb = dram.n_banks
        self.cmds: list[int] = []
        self.banks: list[int] = []
        self.rows: list[int] = []
        self.cols: list[int] = []
        self.datas: list = []
        self.dts: list[int] = []
        self.t = 0
        self.open_row = [-1] * self.nb
        self._act_t = [_NEG] * self.nb
        self._close_t = [_NEG] * self.nb
        self._wr_t = [_NEG] * self.nb
        self._rd_t = [_NEG] * self.nb
        self._acts = collections.deque(maxlen=4)
        self._last_act = self._last_wr = self._last_rw = _NEG
        self._busy_until = 0
        self._slow_entry = False

    def _earliest(self, c: int, b: int) -> int:
        T = self.T
        t = _NEG
        if c != NOP:
            t = max(t, self._busy_until)
        if c == ACT:
            t = max(t, self._close_t[b] + T["tRP"], self._act_t[b] + T["tRC"],
                    self._last_act + T["tRRD"])
            if len(self._acts) == 4:
                t = max(t, self._acts[0] + T["tFAW"])
        elif c == RD or c == WR:
            t = max(t, self._act_t[b] + T["tRCD"], self._last_rw + T["tCCD"])
            if c == RD:
                t = max(t, self._last_wr + T["tBURST"] + T["tWTR"])
        elif c == PRE or c == PREA:
            for tb in (range(self.nb) if c == PREA else (b,)):
                if self.open_row[tb] >= 0:
                    t = max(t, self._act_t[tb] + T["tRAS"],
                            self._wr_t[tb] + T["tBURST"] + T["tWR"],
                            self._rd_t[tb] + T["tRTP"])
        return t

    def emit(self, c, b=0, r=0, co=0, data=None, dt=0) -> None:
        T = self.T
        c, b, r = int(c), int(b), int(r)
        need = self._earliest(c, b)
        if need > self.t:
            if not self.dts:
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
            for tb in range(self.nb):
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
            self._busy_until = max(self._busy_until, self.t + T["tRFC"])
        elif c == PDE:
            self._slow_entry = False
        elif c == PDE_SLOW:
            self._slow_entry = True
        elif c == PDX:
            exit_lat = T["tXPDLL"] if self._slow_entry else T["tXP"]
            self._busy_until = max(self._busy_until, self.t + exit_lat)
        elif c == SRX:
            self._busy_until = max(self._busy_until, self.t + T["tXS"])
        self.t += int(dt)

    def arrays(self, line_words: int) -> dict:
        """The trace as int32 numpy arrays (``data``: ``(n, words)``, the
        uint32 line bits viewed as int32)."""
        n = len(self.cmds)
        data = np.zeros((n, line_words), dtype=np.uint32)
        for i, d in enumerate(self.datas):
            if d is not None:
                data[i] = d
        i32 = np.int32
        return dict(cmd=np.asarray(self.cmds, i32),
                    bank=np.asarray(self.banks, i32),
                    row=np.asarray(self.rows, i32),
                    col=np.asarray(self.cols, i32),
                    data=data.view(i32), dt=np.asarray(self.dts, i32))


# ---------------------------------------------------------------------------
# Byte-value distributions
# ---------------------------------------------------------------------------
def _dist_zeros():
    p = np.full(256, 0.0008)
    p[0x00] = 0.70
    p[0xFF] = 0.05
    p[0x01] = 0.05
    return p / p.sum()


def _dist_ascii():
    p = np.full(256, 0.0004)
    for c in range(0x61, 0x7B):
        p[c] = 0.025
    p[0x20] = 0.12
    for c in range(0x41, 0x5B):
        p[c] = 0.004
    for c in range(0x30, 0x3A):
        p[c] = 0.006
    p[0x0A] = 0.01
    return p / p.sum()


def _dist_int_small():
    p = np.full(256, 0.0008)
    for v, w in ((0x00, 0.32), (0x01, 0.06), (0x02, 0.03), (0x03, 0.02),
                 (0xFF, 0.24), (0xFE, 0.05), (0xFD, 0.02), (0x04, 0.01),
                 (0x08, 0.01), (0x7F, 0.02)):
        p[v] = w
    return p / p.sum()


def _dist_fp32():
    p = np.full(256, 0.002)
    for v, w in ((0x3F, 0.12), (0xBF, 0.10), (0x40, 0.06), (0xC0, 0.05),
                 (0x3E, 0.05), (0xBE, 0.04), (0x00, 0.08), (0x80, 0.03),
                 (0x7F, 0.03)):
        p[v] = w
    return p / p.sum()


def _dist_pointer():
    p = np.full(256, 0.0015)
    p[0x00] = 0.26
    p[0x7F] = 0.14
    p[0xFF] = 0.06
    p[0x55] = 0.04
    for v in range(0x10, 0x90, 0x08):
        p[v] = 0.01
    return p / p.sum()


def _dist_random():
    return np.full(256, 1.0 / 256)


BYTE_DISTS = {
    "zeros": _dist_zeros, "ascii": _dist_ascii, "int_small": _dist_int_small,
    "fp32": _dist_fp32, "pointer": _dist_pointer, "random": _dist_random,
}


@dataclasses.dataclass(frozen=True)
class AppSpec:
    name: str
    intensity: float      # mean fraction of bus cycles doing data bursts
    row_hit: float        # row-buffer hit probability
    read_frac: float
    data_dist: str
    seed: int = 0


# 23 synthetic applications spanning the qualitative range of SPEC CPU2006
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


def sample_lines(dist_name: str, n_lines: int, rng, line_bytes: int):
    """(n_lines, line_bytes // 4) uint32 lines with bytes drawn from the
    distribution."""
    p = BYTE_DISTS[dist_name]()
    b = rng.choice(256, size=(n_lines, line_bytes), p=p).astype(np.uint32)
    return (b[:, 0::4] | (b[:, 1::4] << 8) | (b[:, 2::4] << 16)
            | (b[:, 3::4] << 24)).astype(np.uint32)


def app_trace(app: AppSpec, n_requests: int, dram: Dram,
              entropy=None) -> dict:
    """The command trace of one synthetic application as numpy arrays
    (``TraceBuilder.arrays``); ``entropy`` seeds the stream (default
    ``(29, app.seed)``, the port's)."""
    T = dram.timing
    if entropy is None:
        entropy = (29, app.seed)
    rng = np.random.default_rng(np.random.SeedSequence(list(entropy)))
    lines = sample_lines(app.data_dist, n_requests, rng, dram.line_bytes)

    bld = TraceBuilder(dram)
    ref_anchor = 0
    mean_gap = T["tBURST"] * (1.0 - app.intensity) / max(app.intensity, 0.01)

    bank_seq = rng.integers(0, dram.n_banks, size=n_requests)
    hit_seq = rng.random(n_requests) < app.row_hit
    rd_seq = rng.random(n_requests) < app.read_frac
    row_seq = rng.integers(0, 1 << dram.row_bits, size=n_requests)
    col_seq = rng.integers(0, dram.cols_per_row, size=n_requests)
    gap_seq = rng.geometric(1.0 / (1.0 + mean_gap), size=n_requests) - 1

    for i in range(n_requests):
        b = int(bank_seq[i])
        if hit_seq[i] and bld.open_row[b] >= 0:
            r = bld.open_row[b]
        else:
            r = int(row_seq[i])
            if bld.open_row[b] >= 0:
                bld.emit(PRE, b, dt=T["tRP"])
            bld.emit(ACT, b, r, dt=T["tRCD"])
        op = RD if rd_seq[i] else WR
        gap = int(gap_seq[i])
        if gap > 128:
            if gap > 2048:
                entry, exit_cmd, exit_dt = SRE, SRX, T["tXS"]
            elif gap > 512:
                entry, exit_cmd, exit_dt = PDE_SLOW, PDX, T["tXPDLL"]
            else:
                entry, exit_cmd, exit_dt = PDE, PDX, T["tXP"]
            bld.emit(op, b, r, int(col_seq[i]), lines[i], dt=T["tBURST"])
            bld.emit(PREA, dt=T["tRP"])
            if (entry != SRE and bld.t - ref_anchor + T["tCKE"] + gap
                    + exit_dt >= T["tREFI"]):
                bld.emit(REF, dt=T["tRFC"])
                bld.emit(PREA, dt=0)
                ref_anchor = bld.t
            bld.emit(entry, dt=T["tCKE"])
            bld.emit(NOP, dt=gap)
            bld.emit(exit_cmd, dt=exit_dt)
            if entry == SRE:
                ref_anchor = bld.t
            continue
        bld.emit(op, b, r, int(col_seq[i]), lines[i], dt=T["tBURST"] + gap)
        if bld.t - ref_anchor >= T["tREFI"]:
            bld.emit(PREA, dt=T["tRP"])
            bld.emit(REF, dt=T["tRFC"])
            ref_anchor = bld.t

    return bld.arrays(dram.line_words)
