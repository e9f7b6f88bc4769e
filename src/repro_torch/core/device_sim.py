"""Simulated DRAM module fleet — the stand-in for the paper's 50 physical
DDR3L SO-DIMMs plus the FPGA/SoftMC + current-probe measurement rig.

Ground truth per module = the shared energy integrator with *true*
parameters drawn around the paper's published per-vendor values (Table 5,
Sections 4, 6 and 7), perturbed by seeded per-module process variation,
carrying the vendor's structural per-(bank, row-band) activation surface
(:func:`structural_surface`, identical across modules of a vendor), plus
what a fitted linear model cannot capture exactly: multiplicative
measurement noise per test and a small quadratic term in the
ones-dependence (``ones_quad``).

Everything is seeded by (vendor, module_id, year), exactly as the
reference package seeds it: the rig's process variation from numpy's
``SeedSequence`` (bit for bit), the measurement noise, the synthetic
fleets and the drift from JAX's counter-based Threefry stream
(:mod:`repro_torch.core.threefry`; the bits are JAX's, the float32
normals agree to ~1e-7).  Parameters are float32 tensors on the host;
the measuring engines move them to the device they run on.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import model_api, threefry
from repro_torch.core import params as P
from repro_torch.core.dram import (N_BANKS, N_ROW_BANDS, TCK_NS, TIMING as _T,
                                   VDD, CommandTrace)
from repro_torch.core.energy_model import (EnergyReport, PowerParams,
                                           per_command_energy,
                                           trace_energy_vectorized)


def _gen_scale(key: str, year: int) -> float:
    table = P.GEN_MEASURED_SCALE.get(key)
    if table is None or year >= 2015:
        return 1.0
    idx = {2011: 0, 2012: 1}.get(year, 2)
    return table[idx]


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _as_params(leaves: dict) -> PowerParams:
    """float32 numpy leaves by name -> a ``PowerParams`` of CPU tensors."""
    return PowerParams(**{name: torch.from_numpy(_f32(x).copy())
                          for name, x in leaves.items()})


def _leaves(pp: PowerParams) -> dict:
    return {name: x.numpy() for name, x in zip(pp._fields, pp)}


@functools.lru_cache(maxsize=None)
def structural_surface(vendor: int) -> np.ndarray:
    """The planted per-(bank, row-band) structural ACT-charge surface of a
    vendor (paper Section 6 / Figs 19-22): one seed-stable
    (8, N_ROW_BANDS) multiplicative map shared by EVERY module of the
    vendor.  Band 0 (the band every standard loop and probe addresses) is
    the per-bank reference: exactly 1.0."""
    rng = np.random.default_rng(np.random.SeedSequence([29, vendor]))
    sig = P.STRUCTURAL_SURFACE_SIGMA[vendor]
    surf = np.exp(rng.normal(0.0, sig, (N_BANKS, N_ROW_BANDS)))
    surf /= surf[:, :1]
    return surf


@functools.lru_cache(maxsize=None)
def _vendor_leaves(vendor: int, year: int) -> dict:
    """float32 numpy leaves of :func:`true_vendor_params` (cached; callers
    copy before changing them)."""
    scale_rw = _f32([[_gen_scale("IDD4R", year)], [_gen_scale("IDD4W", year)]])
    datadep = _f32(P.TABLE5[vendor]) * scale_rw[None, :, :]

    i2n = P.MEASURED_IDD["IDD2N"][vendor] * _gen_scale("IDD2N", year)
    delta = np.asarray(P.BANK_OPEN_DELTA[vendor]) * _gen_scale("IDD2N", year)

    # q_actpre from the measured IDD0 anchor.  The loop background follows
    # the integrator (state BEFORE each command): the bank is closed during
    # the ACT slot (tRAS) and open during the PRE slot (tRP), so the
    # simulated IDD0 loop lands exactly on the anchor.
    idd0 = P.MEASURED_IDD["IDD0"][vendor] * _gen_scale("IDD0", year)
    trc_cyc = float(_T.tRAS + _T.tRP)
    bg_loop = (i2n * _T.tRAS + (i2n + float(delta[0])) * _T.tRP) / trc_cyc
    q_actpre = max((idd0 - bg_loop), 5.0) * trc_cyc
    q_ref = (P.MEASURED_IDD["IDD5B"][vendor] - i2n) * float(_T.tRFC)
    return dict(
        datadep=datadep, i2n=_f32(i2n), bank_open_delta=_f32(delta),
        bank_read_factor=_f32(P.BANK_READ_FACTORS[vendor]),
        bank_write_factor=_f32(P.BANK_WRITE_FACTORS[vendor]),
        q_actpre=_f32(q_actpre),
        row_ones_slope=_f32(P.ROW_ONES_SLOPE[vendor]),
        q_ref=_f32(q_ref), i_pd=_f32(P.MEASURED_IDD["IDD2P1"][vendor]),
        io_read_ma_per_one=_f32(P.IO_DRIVER_MA_PER_ONE_READ),
        io_write_ma_per_zero=_f32(P.IO_DRIVER_MA_PER_ZERO_WRITE),
        ones_quad=_f32(P.ONES_QUAD_FRACTION),
        act_surface=_f32(structural_surface(vendor)),
        # the rest of the background-state LUT (Sec 4.2 / Fig 14); i_sr
        # subsumes the per-REF charge (refresh is internal in self-refresh)
        i_pd_slow=_f32(P.MEASURED_IDD["IDD2P0"][vendor]),
        i_actpd=_f32(P.MEASURED_IDD["IDD3P"][vendor]),
        i_sr=_f32(P.MEASURED_IDD["IDD6"][vendor]))


def true_vendor_params(vendor: int, year: int = 2015) -> PowerParams:
    """Vendor-mean ground-truth parameters (no process variation), as
    float32 CPU tensors."""
    return _as_params(_vendor_leaves(vendor, year))


def _module_rng(spec: P.ModuleSpec) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([17, spec.vendor, spec.module_id, spec.year]))


def true_module_params(spec: P.ModuleSpec) -> PowerParams:
    """Per-module ground truth = vendor mean x seeded process variation
    (the reference's draws in the reference's order, so every leaf is bit
    for bit the reference's)."""
    base = _vendor_leaves(spec.vendor, spec.year)
    rng = _module_rng(spec)
    sig = P.PROCESS_SIGMA[spec.vendor]

    def f(scale=1.0):  # one lognormal multiplicative factor, as float32
        return np.float32(np.exp(rng.normal(0.0, sig * scale)))

    dd = base["datadep"] * np.array([float(np.exp(rng.normal(0.0, sig * s)))
                                     for s in (1.0, 0.6, 1.5)])[None, None, :]
    io_f = np.float32(np.exp(rng.normal(0.0, P.IO_DRIVER_SIGMA)))
    io_f2 = np.float32(np.exp(rng.normal(0.0, P.IO_DRIVER_SIGMA)))
    # act_surface is not perturbed: the surface is structural.  The draws
    # below keep the reference's order (the low-power leaves last).
    out = dict(base)
    out.update(
        datadep=_f32(dd),
        i2n=base["i2n"] * f(1.2),
        bank_open_delta=base["bank_open_delta"] * f(),
        q_actpre=base["q_actpre"] * f(),
        q_ref=base["q_ref"] * f(0.5),
        i_pd=base["i_pd"] * f(1.5 if spec.vendor == 1 else 0.6),
        io_read_ma_per_one=base["io_read_ma_per_one"] * io_f,
        io_write_ma_per_zero=base["io_write_ma_per_zero"] * io_f2,
        i_pd_slow=base["i_pd_slow"] * f(0.6),
        i_actpd=base["i_actpd"] * f(0.6),
        i_sr=base["i_sr"] * f(0.5))
    return _as_params(out)


# ---------------------------------------------------------------------------
# Synthetic fleets of any size: every module's variation comes from the
# counter-based stream (``fold_in`` on (vendor, module id, year)), so a
# whole fleet is one vectorized draw, module k's params never depend on the
# fleet around it, and the family is separate from the rig's numpy stream.
# ---------------------------------------------------------------------------
_SYNTH_ROOT = 0xF1EE7

#: per-draw sigma scales, in the ``true_module_params`` draw order
#: (datadep x3, io x2, i2n, bank_open_delta, q_actpre, q_ref, i_pd,
#: i_pd_slow, i_actpd, i_sr); None marks the I/O and i_pd columns.
_SYNTH_SCALES = (1.0, 0.6, 1.5, None, None, 1.2, 1.0, 1.0, 0.5, None,
                 0.6, 0.6, 0.5)


def _module_keys(root: int, *ids):
    k = threefry.key(root)
    for x in ids:
        k = threefry.fold_in(k, x)
    return k


def _synth_factors(vendors, module_ids, years) -> np.ndarray:
    """(n,) module identities -> (n, 13) float32 multiplicative lognormal
    process factors, 13 counter-based normals per module."""
    vendors = np.asarray(vendors, np.uint32)
    z = threefry.normal(_module_keys(_SYNTH_ROOT, vendors, module_ids, years),
                        13)
    sig = _f32(P.PROCESS_SIGMA)[vendors]
    io = np.full_like(sig, P.IO_DRIVER_SIGMA)
    i_pd_scale = np.where(vendors == 1, np.float32(1.5),
                          np.float32(0.6)) * sig
    cols = [io if s is None else np.float32(s) * sig for s in _SYNTH_SCALES]
    cols[3], cols[4], cols[9] = io, io, i_pd_scale
    return np.exp(z * np.stack(cols, axis=1))


def synth_fleet_params(n_modules: int | None = None, *, year: int = 2015,
                       vendors=None, module_ids=None, device=None):
    """Ground-truth ``PowerParams`` of a synthetic fleet of any size ->
    ``((n,) uint32 vendor ids, stacked params on device)`` with a leading
    module axis on every leaf.  Vendors default to round robin over the
    three rig vendors (any prefix of a bigger fleet is itself a fleet);
    ``device`` is ``cuda`` unless the caller names another."""
    device = model_api.resolve_device(device)
    if vendors is None:
        if n_modules is None:
            raise ValueError("need n_modules or an explicit vendors array")
        vendors = np.arange(int(n_modules), dtype=np.uint32) % 3
    vendors = np.asarray(vendors, np.uint32)
    if module_ids is None:
        module_ids = np.arange(vendors.shape[0], dtype=np.uint32)
    module_ids = np.asarray(module_ids, np.uint32)
    years = np.full(vendors.shape, year, np.uint32)

    base = [_vendor_leaves(v, year) for v in range(3)]
    g = {name: np.stack([b[name] for b in base])[vendors.astype(np.int64)]
         for name in PowerParams._fields}
    f = _synth_factors(vendors, module_ids, years)
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
    return vendors, _as_params(g).to(device)


# ---------------------------------------------------------------------------
# Measurement noise: each measurement's multiplicative factor is a pure
# function of (module identity, probe key), so the serial oracle and the
# batched engine draw the same factor for the same (module, probe) pair
# whatever the order, and a (modules, probes) matrix is one call.
# ---------------------------------------------------------------------------
_NOISE_ROOT = 0x5EED
# probe keys below this are reserved for explicitly keyed campaign probes;
# ad-hoc (unkeyed) measurements draw from a per-module counter above it.
_ADHOC_KEY_BASE = 1 << 20


def _noise_normals(vendors, module_ids, years, probe_keys) -> np.ndarray:
    """(M,) module identities x (K,) probe keys -> (M, K) float32 unit
    normals."""
    k = _module_keys(_NOISE_ROOT, np.asarray(vendors, np.uint32),
                     np.asarray(module_ids, np.uint32),
                     np.asarray(years, np.uint32))
    keys = np.asarray(probe_keys, np.uint32)
    pk = threefry.fold_in((k[0][:, None], k[1][:, None]), keys[None, :])
    return threefry.normal(pk, 1)[..., 0]


def measurement_noise_factors(specs, probe_keys) -> np.ndarray:
    """The (len(specs), len(probe_keys)) float32 matrix of multiplicative
    measurement-noise factors, lognormal with sigma
    ``params.MEASUREMENT_NOISE``."""
    z = _noise_normals([s.vendor for s in specs], [s.module_id for s in specs],
                      [s.year for s in specs], probe_keys)
    return np.exp(np.float32(P.MEASUREMENT_NOISE) * z)


@dataclasses.dataclass
class SimulatedModule:
    """One simulated DIMM attached to the simulated measurement rig."""
    spec: P.ModuleSpec
    params: PowerParams = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.params is None:
            self.params = true_module_params(self.spec)
        self._adhoc_probe_counter = _ADHOC_KEY_BASE

    # -- the "multimeter": average current over a looped microbenchmark ----
    def measure_current(self, trace: CommandTrace, noisy: bool = True,
                        skip: int = 0, probe_key: int | None = None) -> float:
        """Average current (mA) on the trace's device.  ``skip`` drops the
        first N commands (one-time setup) from the average, as the rig
        samples only once the steady-state loop runs; ``probe_key`` pins
        the noise draw to a stable key so the serial and batched engines
        agree; without it each call consumes the module's ad-hoc
        counter."""
        pp = self.params.to(trace.device)
        if skip:
            e = per_command_energy(trace, pp)[skip:]
            cyc = trace.dt[skip:].sum(dtype=torch.int32)
            cur = float(e.sum() / (TCK_NS * VDD)
                        / torch.clamp(cyc.to(torch.float32), min=1.0))
        else:
            cur = float(trace_energy_vectorized(trace, pp).avg_current_ma)
        if noisy:
            if probe_key is None:
                probe_key = self._adhoc_probe_counter
                self._adhoc_probe_counter += 1
            cur *= float(measurement_noise_factors([self.spec],
                                                   [probe_key])[0, 0])
        return cur

    def measure_report(self, trace: CommandTrace) -> EnergyReport:
        return trace_energy_vectorized(trace, self.params.to(trace.device))


def make_fleet(specs=None) -> list[SimulatedModule]:
    specs = P.paper_fleet() if specs is None else specs
    return [SimulatedModule(s) for s in specs]


def vendor_modules(fleet, vendor: int):
    return [m for m in fleet if m.spec.vendor == vendor]


# ---------------------------------------------------------------------------
# Drift: the planted ground truth wanders with temperature and age after
# the one-shot campaign (the online-recalibration story).  The trajectory
# is a pure function of (vendor, module id, tick) — counter-based draws
# plus closed-form temperature and aging curves — so any tick's ground
# truth is rebuilt directly and a whole fleet's factors are one draw.
# ---------------------------------------------------------------------------
_DRIFT_ROOT = 0xD81F7

#: PowerParams fields scaled by the background/leakage drift factor
DRIFT_BG_FIELDS = ("i2n", "bank_open_delta", "i_pd", "i_pd_slow",
                   "i_actpd", "i_sr", "q_ref")
#: PowerParams fields scaled by the activation/data drift factor
DRIFT_ACT_FIELDS = ("q_actpre", "datadep")


@dataclasses.dataclass(frozen=True)
class DriftProcess:
    """Seed-stable temperature/aging drift of the planted parameters.

    * ``temp_amp``/``temp_period`` — a sinusoidal ambient-temperature
      trajectory with a seeded per-module phase: thermal wander.
    * ``aging_rate``/``act_aging_rate`` — monotone linear degradation per
      tick of the background and activation groups.
    * ``noise_sigma`` — per-tick lognormal jitter, counter-based on
      (vendor, module, tick).
    * ``step_tick``/``step_frac`` — an optional planted vendor-wide step
      change (both groups) at a known tick."""
    temp_amp: float = 0.03
    temp_period: float = 96.0
    aging_rate: float = 1.2e-3
    act_aging_rate: float = 8e-4
    noise_sigma: float = 0.002
    step_tick: int | None = None
    step_frac: float = 0.0


DEFAULT_DRIFT = DriftProcess()
NO_DRIFT = DriftProcess(temp_amp=0.0, aging_rate=0.0, act_aging_rate=0.0,
                        noise_sigma=0.0)


def drift_factors(vendors, module_ids, tick: int,
                  drift: DriftProcess = DEFAULT_DRIFT):
    """The ((n,) bg, (n,) act) float32 drift factors at any tick."""
    k = _module_keys(_DRIFT_ROOT, np.atleast_1d(np.asarray(vendors, np.uint32)),
                     np.atleast_1d(np.asarray(module_ids, np.uint32)))
    phase = threefry.uniform(threefry.fold_in(k, 0), 1, 0.0,
                             2.0 * np.pi)[..., 0]
    z = threefry.normal(threefry.fold_in(threefry.fold_in(k, 1), tick), 2)
    t = np.float32(tick)
    f32 = np.float32
    season = np.sin(f32(2.0 * np.pi) * t / f32(drift.temp_period) + phase)
    step = f32(1.0)
    if drift.step_tick is not None:
        step = f32(1.0) + f32(drift.step_frac) * f32(tick >= drift.step_tick)
    bg = ((f32(1.0) + f32(drift.temp_amp) * season)
          * (f32(1.0) + f32(drift.aging_rate) * t)
          * np.exp(f32(drift.noise_sigma) * z[:, 0]) * step)
    act = ((f32(1.0) + f32(0.5 * drift.temp_amp) * season)
           * (f32(1.0) + f32(drift.act_aging_rate) * t)
           * np.exp(f32(drift.noise_sigma) * z[:, 1]) * step)
    return bg, act


def apply_drift(stacked: PowerParams, vendors, module_ids, tick,
                drift: DriftProcess = DEFAULT_DRIFT) -> PowerParams:
    """Drifted ground truth at ``tick`` of a module-stacked
    ``PowerParams`` (leading module axis on every leaf)."""
    bg, act = drift_factors(vendors, module_ids, tick, drift)
    updates = {}
    for field in DRIFT_BG_FIELDS + DRIFT_ACT_FIELDS:
        leaf = getattr(stacked, field)
        f = torch.from_numpy(bg if field in DRIFT_BG_FIELDS else act).to(
            leaf.device)
        updates[field] = leaf * f.reshape(f.shape + (1,) * (leaf.ndim - 1))
    return stacked._replace(**updates)


def drifted_module_params(spec: P.ModuleSpec, tick: int,
                          drift: DriftProcess = DEFAULT_DRIFT) -> PowerParams:
    """One module's drifted ground truth at ``tick`` (rig family)."""
    stacked = PowerParams(*(x[None] for x in true_module_params(spec)))
    out = apply_drift(stacked, [spec.vendor], [spec.module_id], tick, drift)
    return out.select(0)


def drifted_fleet(fleet, tick: int, drift: DriftProcess = DEFAULT_DRIFT):
    """The rig fleet with every module's params replaced by the drifted
    ground truth at ``tick`` (fresh modules; the input is untouched)."""
    return [SimulatedModule(m.spec,
                            drifted_module_params(m.spec, tick, drift))
            for m in fleet]
