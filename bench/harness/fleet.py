"""The benchmark's synthetic fleet: ground-truth VAMPIRE parameters of
any number of modules, in numpy, drawn from the run's seed.

A copy of ``repro_torch/core/device_sim.py``'s ``synth_fleet_params``
with the parameter tables of ``repro_torch/core/params.py`` it reads
(origin: commit 3b119a0).  The per-module process factors come from
numpy's ``default_rng`` seeded by the run's seed, not from the port's
Threefry stream: the fleet is an input that the benchmark hands to the
program and to the reference alike, so its bits need not match the
port's own draw.  Modules of year 2015 only (the generational scales
are 1 there).
"""
from __future__ import annotations

import numpy as np

# ---- the tables (repro_torch/core/params.py), vendors A, B, C --------------
TABLE5 = np.array([
    [[[250.88, 0.449, 0.0000], [489.61, -0.217, 0.0000]],
     [[246.44, 0.433, 0.0515], [531.18, -0.246, 0.0461]],
     [[287.24, 0.244, 0.0200], [534.93, -0.249, 0.0225]],
     [[277.13, 0.267, 0.0200], [537.58, -0.249, 0.0225]]],
    [[[226.69, 0.164, 0.0000], [447.95, -0.191, 0.0000]],
     [[217.42, 0.157, 0.0947], [466.84, -0.215, 0.0166]],
     [[228.14, 0.159, 0.0364], [419.99, -0.179, 0.0078]],
     [[223.61, 0.152, 0.0364], [420.43, -0.179, 0.0078]]],
    [[[222.11, 0.134, 0.0000], [343.41, -0.000, 0.0000]],
     [[234.42, 0.154, 0.0856], [368.29, -0.116, 0.0229]],
     [[289.99, 0.034, 0.0455], [304.33, -0.054, 0.0455]],
     [[266.51, 0.099, 0.0090], [323.22, -0.072, 0.0090]]],
], dtype=np.float64)

MEASURED_IDD = {
    "IDD2N": (32.0, 60.0, 45.0),
    "IDD0": (72.2, 70.4, 58.1),
    "IDD5B": (182.0, 164.0, 195.0),
    "IDD2P1": (10.9, 41.6, 23.1),
    "IDD2P0": (5.2, 18.4, 9.7),
    "IDD3P": (19.8, 52.3, 38.9),
    "IDD6": (7.4, 24.1, 13.6),
}
PROCESS_SIGMA = (0.085, 0.095, 0.088)
IO_DRIVER_SIGMA = 0.15
ONES_QUAD_FRACTION = 0.012
IO_DRIVER_MA_PER_ONE_READ = 0.40
IO_DRIVER_MA_PER_ZERO_WRITE = 0.39
BANK_OPEN_DELTA = np.array([
    [1.753, 1.748, 1.751, 1.749, 1.752, 1.747, 1.750, 1.750],
    [1.502, 1.497, 1.503, 1.501, 1.499, 1.498, 1.500, 1.500],
    [5.000, 16.62, 11.00, 14.90, 9.200, 13.50, 8.080, 12.00],
], dtype=np.float64)
BANK_READ_FACTORS = np.array([
    [1.000, 1.031, 0.985, 1.044, 0.992, 1.038, 0.978, 1.022],
    [1.000, 0.973, 1.028, 0.981, 1.035, 0.969, 1.024, 0.988],
    [1.000, 1.052, 0.964, 1.041, 0.957, 1.063, 0.972, 1.035],
], dtype=np.float64)
BANK_WRITE_FACTORS = np.ones((3, 8), dtype=np.float64)
ROW_ONES_SLOPE = np.array([0.12, 0.146, 0.03]) / 15.0
STRUCTURAL_SURFACE_SIGMA = (0.03, 0.04, 0.10)

#: the leaves of a parameter set, in the port's ``PowerParams`` order
FIELDS = ("datadep", "i2n", "bank_open_delta", "bank_read_factor",
          "bank_write_factor", "q_actpre", "row_ones_slope", "q_ref", "i_pd",
          "io_read_ma_per_one", "io_write_ma_per_zero", "ones_quad",
          "act_surface", "i_pd_slow", "i_actpd", "i_sr")

#: per-draw sigma scales in the port's draw order (datadep x3, io x2,
#: i2n, bank_open_delta, q_actpre, q_ref, i_pd, i_pd_slow, i_actpd,
#: i_sr); None marks the I/O and i_pd columns
_SCALES = (1.0, 0.6, 1.5, None, None, 1.2, 1.0, 1.0, 0.5, None,
           0.6, 0.6, 0.5)


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def structural_surface(vendor: int, n_banks: int, n_bands: int):
    """The vendor's per-(bank, row-band) ACT-charge surface (band 0 is
    exactly 1 per bank), seeded by the vendor as the port seeds it."""
    rng = np.random.default_rng(np.random.SeedSequence([29, vendor]))
    surf = np.exp(rng.normal(0.0, STRUCTURAL_SURFACE_SIGMA[vendor],
                             (n_banks, n_bands)))
    return surf / surf[:, :1]


def vendor_leaves(vendor: int, tim: dict, n_banks: int,
                  n_bands: int) -> dict:
    """The vendor-mean parameter leaves of a 2015 module (float32)."""
    i2n = MEASURED_IDD["IDD2N"][vendor]
    delta = BANK_OPEN_DELTA[vendor]
    idd0 = MEASURED_IDD["IDD0"][vendor]
    trc_cyc = float(tim["tRAS"] + tim["tRP"])
    bg_loop = (i2n * tim["tRAS"] + (i2n + float(delta[0])) * tim["tRP"]) \
        / trc_cyc
    q_actpre = max(idd0 - bg_loop, 5.0) * trc_cyc
    q_ref = (MEASURED_IDD["IDD5B"][vendor] - i2n) * float(tim["tRFC"])
    return dict(
        datadep=_f32(TABLE5[vendor]), i2n=_f32(i2n),
        bank_open_delta=_f32(delta),
        bank_read_factor=_f32(BANK_READ_FACTORS[vendor]),
        bank_write_factor=_f32(BANK_WRITE_FACTORS[vendor]),
        q_actpre=_f32(q_actpre), row_ones_slope=_f32(ROW_ONES_SLOPE[vendor]),
        q_ref=_f32(q_ref), i_pd=_f32(MEASURED_IDD["IDD2P1"][vendor]),
        io_read_ma_per_one=_f32(IO_DRIVER_MA_PER_ONE_READ),
        io_write_ma_per_zero=_f32(IO_DRIVER_MA_PER_ZERO_WRITE),
        ones_quad=_f32(ONES_QUAD_FRACTION),
        act_surface=_f32(structural_surface(vendor, n_banks, n_bands)),
        i_pd_slow=_f32(MEASURED_IDD["IDD2P0"][vendor]),
        i_actpd=_f32(MEASURED_IDD["IDD3P"][vendor]),
        i_sr=_f32(MEASURED_IDD["IDD6"][vendor]))


def synth_fleet(n_modules: int, seed_entropy, tim: dict, n_banks: int = 8,
                n_bands: int = 8) -> dict:
    """Stacked float32 parameter leaves (leading module axis) of a fleet
    of ``n_modules`` modules, vendors round robin over A, B, C, each
    module's 13 lognormal process factors drawn from ``seed_entropy``."""
    vendors = np.arange(int(n_modules)) % 3
    base = [vendor_leaves(v, tim, n_banks, n_bands) for v in range(3)]
    g = {name: np.stack([b[name] for b in base])[vendors] for name in FIELDS}
    rng = np.random.default_rng(np.random.SeedSequence(list(seed_entropy)))
    z = rng.standard_normal((vendors.shape[0], 13)).astype(np.float32)
    sig = _f32(PROCESS_SIGMA)[vendors]
    io = np.full_like(sig, IO_DRIVER_SIGMA)
    cols = [io if s is None else np.float32(s) * sig for s in _SCALES]
    cols[9] = np.where(vendors == 1, np.float32(1.5),
                       np.float32(0.6)) * sig
    f = np.exp(z * np.stack(cols, axis=1)).astype(np.float32)
    g.update(
        datadep=g["datadep"] * f[:, None, None, 0:3],
        i2n=g["i2n"] * f[:, 5],
        bank_open_delta=g["bank_open_delta"] * f[:, 6, None],
        q_actpre=g["q_actpre"] * f[:, 7],
        q_ref=g["q_ref"] * f[:, 8],
        i_pd=g["i_pd"] * f[:, 9],
        io_read_ma_per_one=g["io_read_ma_per_one"] * f[:, 3],
        io_write_ma_per_zero=g["io_write_ma_per_zero"] * f[:, 4],
        i_pd_slow=g["i_pd_slow"] * f[:, 10],
        i_actpd=g["i_actpd"] * f[:, 11],
        i_sr=g["i_sr"] * f[:, 12])
    return {name: np.ascontiguousarray(_f32(g[name])) for name in FIELDS}
