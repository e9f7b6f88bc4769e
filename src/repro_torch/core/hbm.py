"""HBM adaptation of the paper's model (hardware-adaptation layer).

The paper characterizes DDR3L DIMMs.  An accelerator's memory system is
HBM (the H100 this port runs on carries HBM3): no exposed ACT/PRE command
stream, but the same physics — read/write energy depends on the bytes
moved and, per the paper's key observation O2, on the *data values*
moved.  This module extrapolates the fitted VAMPIRE read/write
data-dependency model to an HBM-like energy-per-byte model, and combines
it with a step's read and write traffic, which the caller supplies.  It is
an explicitly labeled extrapolation: constants are rescaled, the
functional form is the paper's.

Energy-per-bit scaling: DDR3L at 1.35 V costs ~hundreds of mA for a 64 B
burst in ~10 ns, i.e. O(10) pJ/bit at the device level.  Published HBM2e
figures are ~3.5-4 pJ/bit device+PHY.  The fitted DDR3L model is rescaled
by the ratio of its own random-line read (write) energy to that anchor,
keeping the paper's *relative* data dependency (ones fraction, toggle
rate).  The anchors below are published HBM2e figures, not measurements
of any card; they match the reference package's, so both packages give
the same numbers.

:func:`tensor_stats` measures a tensor's ones and toggle fractions
through the popcount and toggle kernels, counting in int64 so that a
tensor of any size (e.g. 1 GiB of all-ones data, 2^33 ones) is exact.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dram import LINE_BITS, LINE_BYTES, TCK_NS, TIMING, VDD
from repro_torch.core.energy_model import PowerParams

# Published HBM2e anchors: pJ per bit for a random-data read / write at the
# device+PHY level.
HBM2E_PJ_PER_BIT_READ = 3.9
HBM2E_PJ_PER_BIT_WRITE = 4.1
HBM_STATIC_W = 6.0  # background+refresh per stack, coarse published anchor


@dataclasses.dataclass(frozen=True)
class HbmEnergyModel:
    """Data-dependent HBM read/write energy, VAMPIRE functional form."""
    pj_per_line_read_zero: float
    pj_per_line_read_per_one: float
    pj_per_line_read_per_toggle: float
    pj_per_line_write_zero: float
    pj_per_line_write_per_one: float
    pj_per_line_write_per_toggle: float

    @classmethod
    def from_vampire(cls, pp: PowerParams) -> "HbmEnergyModel":
        """Rescale one vendor's fitted DDR3L model to the HBM2e anchors,
        preserving the paper's relative data dependency.  The arithmetic
        runs in the parameters' float32, as the reference's does."""
        dd = pp.datadep.detach().cpu().numpy()  # (4,2,3); bank-interleaved
        rd0, rd1, rdt = dd[2, 0]
        wr0, wr1, wrt = dd[2, 1]
        io_rd = float(pp.io_read_ma_per_one)
        io_wr = float(pp.io_write_ma_per_zero)
        burst_ns = TIMING.tBURST * TCK_NS
        # DDR3L per-line energies (pJ) at 0 / per-one / per-toggle:
        e_rd0 = rd0 * VDD * burst_ns
        e_rd1 = (rd1 + io_rd) * VDD * burst_ns
        e_rdt = rdt * VDD * burst_ns
        e_wr0 = (wr0 + io_wr * LINE_BITS) * VDD * burst_ns
        e_wr1 = (wr1 - io_wr) * VDD * burst_ns
        e_wrt = wrt * VDD * burst_ns
        # rescale so a random line (50% ones) hits the HBM2e anchor
        tgt_rd = HBM2E_PJ_PER_BIT_READ * LINE_BITS
        tgt_wr = HBM2E_PJ_PER_BIT_WRITE * LINE_BITS
        s_rd = tgt_rd / (e_rd0 + e_rd1 * LINE_BITS / 2)
        s_wr = tgt_wr / (e_wr0 + e_wr1 * LINE_BITS / 2)
        return cls(e_rd0 * s_rd, e_rd1 * s_rd, e_rdt * s_rd,
                   e_wr0 * s_wr, e_wr1 * s_wr, e_wrt * s_wr)

    # ------------------------------------------------------------------
    def read_energy_pj(self, n_bytes, ones_frac, toggle_frac=0.25):
        lines = n_bytes / LINE_BYTES
        return lines * (self.pj_per_line_read_zero
                        + self.pj_per_line_read_per_one * ones_frac * LINE_BITS
                        + self.pj_per_line_read_per_toggle
                        * toggle_frac * LINE_BITS)

    def write_energy_pj(self, n_bytes, ones_frac, toggle_frac=0.25):
        lines = n_bytes / LINE_BYTES
        return lines * (self.pj_per_line_write_zero
                        + self.pj_per_line_write_per_one
                        * ones_frac * LINE_BITS
                        + self.pj_per_line_write_per_toggle
                        * toggle_frac * LINE_BITS)


def tensor_stats(x: torch.Tensor) -> tuple[float, float]:
    """(ones_fraction, toggle_fraction) of a tensor's raw bytes, through
    the popcount and toggle kernels on the tensor's own device (their plain
    versions for a CPU tensor).  Counts add up in int64."""
    from repro_torch.kernels.popcount import ops as pops
    from repro_torch.kernels.toggle import ops as tops
    lines = _tensor_lines(x)
    ones = pops.line_ones(lines).sum(dtype=torch.int64)
    togg = tops.line_toggles_seq(lines).sum(dtype=torch.int64)
    n = lines.shape[0]
    return (int(ones) / (n * LINE_BITS),
            int(togg) / (max(n - 1, 1) * LINE_BITS))


def _tensor_lines(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as ``(n_lines, 16)`` int32 cache lines: the memory
    bytes packed little-endian into 32-bit words (the reference's bitcast
    for 4-, 2- and 1-byte types), a trailing partial line dropped.  A view
    when the tensor's bytes are contiguous and 16-byte aligned."""
    if x.element_size() not in (1, 2, 4):
        raise ValueError(f"unsupported dtype {x.dtype}")
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    raw = raw[:(raw.numel() // LINE_BYTES) * LINE_BYTES]
    if raw.data_ptr() % 16:
        raw = raw.clone()
    return raw.view(torch.int32).reshape(-1, LINE_BYTES // 4)


@dataclasses.dataclass
class StepEnergyReport:
    """Per-train/serve-step HBM energy estimate for one device."""
    read_bytes: float
    write_bytes: float
    read_pj: float
    write_pj: float
    static_pj: float
    total_pj: float
    ones_frac: float
    toggle_frac: float

    @property
    def total_j(self):
        return self.total_pj * 1e-12


def step_energy(model: HbmEnergyModel, *, read_bytes: float,
                write_bytes: float, step_seconds: float,
                ones_frac: float = 0.5, toggle_frac: float = 0.25
                ) -> StepEnergyReport:
    """Combine a step's HBM traffic with data statistics -> energy."""
    rpj = float(model.read_energy_pj(read_bytes, ones_frac, toggle_frac))
    wpj = float(model.write_energy_pj(write_bytes, ones_frac, toggle_frac))
    spj = HBM_STATIC_W * step_seconds * 1e12
    return StepEnergyReport(read_bytes, write_bytes, rpj, wpj, spj,
                            rpj + wpj + spj, ones_frac, toggle_frac)
