"""Online recalibration from streaming telemetry (the ``'streaming'``
fitter of the ``model_api`` fitter registry), in PyTorch.

The offline campaign (``repro_torch.core.characterize``) measures every
probe cell once and inverts the slot accounting once — and then the
planted ground truth keeps drifting (``device_sim.DriftProcess``:
temperature, aging), so the fitted model goes stale exactly the way the
paper showed datasheets do.  This module closes the loop, as
``repro.core.recalibrate`` does:

* :class:`TelemetrySource` — the drifting rig.  Each tick it measures a
  fixed-width round-robin SLICE of the campaign's probe cells on the live
  (drifted) fleet, re-keying the measurement noise per tick: the drift
  factors, then ``fleet.fleet_measure_current`` (``impl='vectorized'``)
  or ``fleet.fleet_measure_current_cuda`` (``impl='cuda'``: the feature
  and VAMPIRE charge kernels, modules on the kernels' vendor axis).
* :class:`StreamingFitter` — the estimation side.  It keeps decayed
  running sufficient statistics per (module, cell) as float32 tensors on
  the model's device, updated in place by one step per tick
  (:func:`fitting.decayed_moment_update`), scores each incoming slice
  against the current model's predicted cell currents (per-key
  standardized residuals — the drift detector), and on demand re-runs the
  campaign's inversion (``characterize.invert_campaign``) over the decayed
  cell means.  The refreshed :class:`~repro_torch.core.vampire.Vampire`
  keeps the original's band, datasheet table, vendor ids and order, leaf
  shapes, dtypes and device, so ``ServingEngine.update_model`` swaps it in
  without a new batch shape; its ``params(v)`` and ``save`` give the
  refreshed parameters (its campaign arrays are the refit's own).
* :func:`fleet_current_mape` — the evaluation yardstick: model-predicted
  against ground-truth loop currents over a validation batch.

Telemetry noise keys live at :data:`_TELEMETRY_KEY_BASE` (1 << 24), far
above the campaign's ``_IDD_KEY_BASE``/``_PROBE_KEY_BASE`` and the
simulator's ad-hoc counter base (1 << 20), striding by tick so every tick
draws fresh, reconstructible noise.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import characterize, device_sim, fitting, fleet
from repro_torch.core import model_api
from repro_torch.core import params as P
from repro_torch.core.characterize import IDD_KEYS
from repro_torch.core.device_sim import DEFAULT_DRIFT, DriftProcess
from repro_torch.core.energy_model import (StructuralFeatures,
                                           extract_structural_features)
from repro_torch.core.fleet import ProbeBatch

# Per-tick telemetry noise keys: base + tick * stride + campaign key.  The
# stride clears every campaign key (< _PROBE_KEY_BASE + a few hundred) and
# the base clears the simulator's ad-hoc counter family (1 << 20), so no
# (module, key) noise draw ever collides across families or ticks.
_TELEMETRY_KEY_BASE = 1 << 24
_TELEMETRY_KEY_STRIDE = 1 << 13


@dataclasses.dataclass(frozen=True)
class RecalConfig:
    """Shape of the telemetry stream and the incremental fit.

    The campaign-plan knobs (``probe_reps``/``n_rows``/``rng_seed``) pick
    WHICH probe cells exist — they must match between the telemetry source
    and the fitter, which is why both take one config.  ``decay`` is the
    per-observation retention of old evidence per cell (1.0 = plain
    running mean); ``slice_size`` is the fixed telemetry width per tick;
    ``drift_threshold`` is the standardized-residual trigger;
    ``detector_floor`` is the relative systematic-error floor folded into
    the residual scale (the linear fit cannot reproduce the planted
    ``ones_quad`` curvature exactly, so pure measurement-noise scaling
    would false-positive on a healthy model)."""
    probe_reps: int = 64
    n_rows: int = 8
    rng_seed: int = 0
    probe_modules: int = 2
    decay: float = 0.9
    slice_size: int = 64
    drift_threshold: float = 3.0
    detector_floor: float = 0.01
    seed_weight: float = 1.0


@functools.lru_cache(maxsize=4)
def _recal_cells(probe_reps: int, n_rows: int, rng_seed: int):
    """(plan, points, padded CPU batch) of the full probe-cell set: the
    campaign's IDD loops first (cells 0..11), then every probe point."""
    plan = characterize.campaign_plan(probe_reps=probe_reps, n_rows=n_rows,
                                      rng_seed=rng_seed)
    points = tuple(plan.idd_points) + tuple(plan.probe_points)
    return plan, points, ProbeBatch.from_points(points)


def recal_cells(config: RecalConfig):
    return _recal_cells(config.probe_reps, config.n_rows, config.rng_seed)


def cell_group(label: tuple) -> str:
    """The drift detector's per-key grouping of a probe-cell label."""
    if label[0] == "idd":
        return f"idd/{label[1]}"
    return str(label[0])


class CellSet:
    """The probe-cell set of a config on a device and its noise-free
    (modules, cells) currents through ``impl``: ``'vectorized'``
    (``fleet.fleet_measure_current``) or ``'cuda'``
    (``fleet.fleet_measure_current_cuda``: the feature and VAMPIRE charge
    kernels on every call).

    ``batch`` is the whole set padded to its longest cell (the
    reference's layout); the currents are computed on the campaign's two
    batches instead, the IDD loops (12 x 1536 commands) and the probes
    (348 x 262 at the quick plan), which pad far less — padding adds no
    charge, so the currents are the same.  For ``'vectorized'`` the
    structural pass of each batch, which depends on the traces only, runs
    once and a slice takes its rows."""

    def __init__(self, config: RecalConfig, impl: str, device):
        self.impl = model_api.resolve_impl(impl).name
        if self.impl not in ("vectorized", "cuda"):
            raise ValueError(f"impl {impl!r} has no batched fleet "
                             "measurement; use 'vectorized' or 'cuda'")
        self.plan, self.points, batch = recal_cells(config)
        self.batch = batch.to(device)
        self._groups = []          # (first cell, batch, structural pass)
        first = 0
        for name in ("idd_batch", "probe_batch"):
            b = self.plan.batch_on(name, device)
            sf = (extract_structural_features(b.trace)
                  if self.impl == "vectorized" else None)
            self._groups.append((first, b, sf))
            first += b.weight.shape[0]

    def __len__(self) -> int:
        return len(self.points)

    def currents(self, stacked, idx=None) -> torch.Tensor:
        """float32 (modules, cells) currents of the cells ``idx`` (all
        when None) under the module-stacked params ``stacked``."""
        idx = np.arange(len(self)) if idx is None else np.asarray(idx)
        dev = self.batch.weight.device
        out = torch.empty((stacked.i2n.shape[0], len(idx)),
                          dtype=torch.float32, device=dev)
        for first, batch, sf in self._groups:
            n = batch.weight.shape[0]
            cols = np.flatnonzero((idx >= first) & (idx < first + n))
            if not len(cols):
                continue
            rows = idx[cols] - first
            if len(rows) != n or (rows != np.arange(n)).any():
                batch = batch.select(rows)
                if sf is not None:
                    r = torch.as_tensor(rows, dtype=torch.long, device=dev)
                    sf = StructuralFeatures(*(x[r] for x in sf))
            if sf is None:
                cur = fleet.fleet_measure_current_cuda(batch.trace,
                                                       batch.weight, stacked)
            else:
                cur = fleet.fleet_measure_current(batch.trace, batch.weight,
                                                  stacked, sf=sf)
            out[:, torch.as_tensor(cols, dtype=torch.long, device=dev)] = cur
        return out


# ---------------------------------------------------------------------------
# The drifting rig
# ---------------------------------------------------------------------------
class TelemetrySource:
    """Per-tick probe-cell telemetry from a drifting simulated fleet.

    Each tick measures a fixed-width round-robin slice of the cell set on
    every module, under the seed-stable drifted ground truth
    (``device_sim.apply_drift``) and fresh per-tick measurement noise —
    the streaming stand-in for the rig's continuous monitoring loop.  The
    fleet's stacked params and the cell batch live on ``device`` (``cuda``
    unless the caller names another)."""

    def __init__(self, modules, config: RecalConfig | None = None, *,
                 drift: DriftProcess = DEFAULT_DRIFT, noisy: bool = True,
                 impl: str = "vectorized", device=None):
        self.modules = list(modules)
        self.config = RecalConfig() if config is None else config
        self.drift = drift
        self.noisy = noisy
        self.device = model_api.resolve_device(device)
        self.specs = [m.spec for m in self.modules]
        self.cells = CellSet(self.config, impl, self.device)
        self.plan, self.points = self.cells.plan, self.cells.points
        self.batch = self.cells.batch
        self.n_cells = len(self.cells)
        self.base_stack = fleet.fleet_stacked(self.modules, self.device)
        self._v = np.asarray([s.vendor for s in self.specs], np.uint32)
        self._m = np.asarray([s.module_id for s in self.specs], np.uint32)

    def slice_indices(self, tick: int) -> np.ndarray:
        """The round-robin cell slice of a tick (fixed width)."""
        width = min(self.config.slice_size, self.n_cells)
        return (tick * width + np.arange(width)) % self.n_cells

    def measure(self, tick: int, cell_idx=None):
        """-> ((modules, cells) float64 currents, cell indices) at
        ``tick``."""
        idx = (self.slice_indices(tick) if cell_idx is None
               else np.asarray(cell_idx))
        cur = self.cells.currents(self.true_params_at(tick), idx)
        cur = cur.cpu().numpy().astype(np.float64)
        if self.noisy:
            keys = (_TELEMETRY_KEY_BASE
                    + np.int64(tick) * _TELEMETRY_KEY_STRIDE
                    + np.asarray(self.batch.keys[idx], np.int64))
            cur = cur * device_sim.measurement_noise_factors(self.specs,
                                                             keys)
        return cur, idx

    def true_params_at(self, tick: int):
        """The reconstructed ground-truth parameter stack at any tick."""
        return device_sim.apply_drift(self.base_stack, self._v, self._m,
                                      int(tick), self.drift)


# ---------------------------------------------------------------------------
# The incremental fitter
# ---------------------------------------------------------------------------
class RunningStats(NamedTuple):
    """Decayed per-(module, cell) sufficient statistics: float32 moment
    tensors (evidence mass + exponentially weighted mean current)."""
    weight: torch.Tensor   # (modules, cells) float32
    mean: torch.Tensor     # (modules, cells) float32


def _update_stats(stats: RunningStats, currents: torch.Tensor,
                  cell_idx: torch.Tensor, decay: torch.Tensor,
                  predicted: torch.Tensor, scale_floor: torch.Tensor):
    """ONE incremental update step, float32 end to end: decay the observed
    cells' moments into the new observations (written into ``stats`` in
    place) and score the incoming slice against the current model's
    predicted cell currents.

    Returns ``(stats, z)`` where ``z`` is the per-cell standardized
    residual of the slice's module-mean current against the model's
    prediction — scaled by measurement noise of the mean plus the
    relative systematic floor (see ``RecalConfig.detector_floor``)."""
    w = stats.weight[:, cell_idx]
    m = stats.mean[:, cell_idx]
    new_w, new_m = fitting.decayed_moment_update(w, m, currents, decay)
    stats.weight[:, cell_idx] = new_w
    stats.mean[:, cell_idx] = new_m
    meas = currents.mean(dim=0)
    pred = predicted[:, cell_idx].mean(dim=0)
    # a Python float: it keeps the float32 tensors float32
    noise = P.MEASUREMENT_NOISE / math.sqrt(currents.shape[0])
    scale = pred.abs() * (noise + scale_floor) + 1e-6
    return stats, (meas - pred) / scale


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One telemetry tick's drift verdict."""
    tick: int
    score: float                 # worst per-key standardized residual
    by_key: dict[str, float]     # mean |z| per probe-cell group
    triggered: bool


def _saved_bands(model) -> dict[int, tuple[float, float]]:
    """Each vendor's variation band as the model holds it: the float64
    band of its campaign arrays where it has them, else its leaves."""
    saved = getattr(model, "saved", None)
    if saved is not None and "band" in saved.arrays:
        ids = [int(v) for v in saved.arrays["vendor_ids"]]
        return {v: tuple(float(x) for x in saved.arrays["band"][i])
                for i, v in enumerate(ids)}
    return {v: tuple(float(x) for x in row)
            for v, row in zip(model.vendors, model.fleet.band.cpu().tolist())}


class StreamingFitter:
    """The ``'streaming'`` fitter: decayed sufficient statistics per probe
    cell, a per-key drift detector, and model refreshes of the same shape.

    Build one via ``model_api.fit(fitter='streaming')`` (or
    :func:`streaming_fitter`), feed it telemetry with :meth:`observe`, and
    hand :meth:`refit` results to ``ServingEngine.update_model``.  The
    statistics and the predictions live on the model's device; ``impl``
    (``'vectorized'`` or ``'cuda'``) computes the predicted currents."""

    def __init__(self, model, specs, config: RecalConfig | None = None, *,
                 impl: str = "vectorized"):
        self.config = RecalConfig() if config is None else config
        self.specs = list(specs)
        self.device = model.device
        self.cells = CellSet(self.config, impl, self.device)
        self.plan, self.points = self.cells.plan, self.cells.points
        self.n_cells = len(self.cells)
        self.groups = [cell_group(p.label) for p in self.points]
        self.model = model
        vendor_order = list(model.vendors)
        self._vendor_rows = {
            v: [i for i, s in enumerate(self.specs) if s.vendor == v]
            for v in vendor_order}
        self._pred_rows = [vendor_order.index(s.vendor) for s in self.specs]
        self._decay = torch.tensor(self.config.decay, dtype=torch.float32,
                                   device=self.device)
        self._floor = torch.tensor(self.config.detector_floor,
                                   dtype=torch.float32, device=self.device)
        self._refresh_predictions()
        # seed the moments with the model's own predicted currents: every
        # cell is defined before its first telemetry arrives, and a refit
        # with no evidence reproduces (approximately) the current model
        self.stats = RunningStats(
            torch.full((len(self.specs), self.n_cells),
                       self.config.seed_weight, dtype=torch.float32,
                       device=self.device),
            self._predicted.clone())
        self.ticks_observed = 0
        self.last_report: DriftReport | None = None

    def _refresh_predictions(self) -> None:
        """(modules, cells) noise-free currents the CURRENT model implies
        for every probe cell — the drift detector's reference (the same
        measurement as the telemetry source's)."""
        self._predicted = self.cells.currents(
            self.model.fleet.params.select(self._pred_rows))

    # ------------------------------------------------------------- ingest
    def observe(self, currents, cell_idx, tick: int) -> DriftReport:
        """Fold one telemetry slice into the sufficient statistics and
        score it for drift.  ``currents`` is (modules, cells) over the
        SAME module order as ``specs``; ``cell_idx`` indexes the cell
        set."""
        cells = np.asarray(cell_idx)
        idx = torch.as_tensor(cells, dtype=torch.long, device=self.device)
        cur = torch.as_tensor(np.asarray(currents, np.float32),
                              device=self.device)
        self.stats, z = _update_stats(self.stats, cur, idx, self._decay,
                                      self._predicted, self._floor)
        z = np.abs(z.cpu().numpy().astype(np.float64))
        by_key: dict[str, list] = {}
        for j, cell in enumerate(cells):
            by_key.setdefault(self.groups[int(cell)], []).append(z[j])
        scores = {k: float(np.mean(v)) for k, v in sorted(by_key.items())}
        score = max(scores.values()) if scores else 0.0
        self.ticks_observed += 1
        self.last_report = DriftReport(
            tick=int(tick), score=score, by_key=scores,
            triggered=score >= self.config.drift_threshold)
        return self.last_report

    # -------------------------------------------------------------- refit
    def refit(self):
        """Invert the decayed cell means into fresh per-vendor parameters
        and return the refreshed model (also adopted as the detector's new
        reference).  It keeps the original's band, datasheet table, vendor
        ids and order, leaf shapes, dtypes and device; its campaign arrays
        (``saved``) are the refit's, so ``params(v)`` and ``save`` agree."""
        from repro_torch.core.vampire import FleetModel, Vampire
        mean = self.stats.mean.cpu().numpy().astype(np.float64)
        by_vendor = {}
        for v, rows in self._vendor_rows.items():
            idd = {key: mean[rows, i] for i, key in enumerate(IDD_KEYS)}
            probe_rows = rows[:self.config.probe_modules]
            pm = mean[probe_rows, len(IDD_KEYS):].mean(axis=0)
            cur = {pt.label: float(pm[i])
                   for i, pt in enumerate(self.plan.probe_points)}
            by_vendor[v] = characterize.invert_campaign(self.plan, v, cur,
                                                        idd)
        old = self.model
        params = fleet.stack_params(
            [by_vendor[v].build_params(self.device) for v in old.vendors])
        bands = _saved_bands(old)
        self.model = Vampire(
            FleetModel(params, old.fleet.band, old.fleet.idd_datasheet,
                       old.fleet.vendor_ids),
            old.idd_keys,
            model_api.saved_fit_from_campaign(by_vendor, bands))
        self._refresh_predictions()
        return self.model


def streaming_fitter(modules=None, *, init_model=None,
                     config: RecalConfig | None = None,
                     impl: str = "vectorized", device=None, **campaign_kw):
    """Factory behind ``model_api.fit(..., fitter='streaming')``: prime a
    :class:`StreamingFitter` on an initial model (``init_model=``, moved
    to ``device`` when one is named, or a fresh campaign fit of the fleet
    on ``device`` with the config's plan knobs through ``impl``)."""
    modules = device_sim.make_fleet() if modules is None else list(modules)
    config = RecalConfig() if config is None else config
    if init_model is None:
        init_model = model_api.fit(
            "vampire", modules, fitter="campaign",
            probe_modules=config.probe_modules,
            probe_reps=config.probe_reps, n_rows=config.n_rows,
            rng_seed=config.rng_seed, impl=impl, device=device,
            **campaign_kw)
    elif device is not None:
        init_model = init_model.to(device)
    return StreamingFitter(init_model, [m.spec for m in modules], config,
                           impl=impl)


# ---------------------------------------------------------------------------
# Evaluation yardstick
# ---------------------------------------------------------------------------
def fleet_current_mape(model, trace, weight, specs, true_stacked,
                       impl: str = "vectorized") -> float:
    """Mean absolute relative current error of ``model`` against a
    (possibly drifted) ground-truth parameter stack over a padded
    validation batch: both sides run through the same measurement
    (``impl``), on the model's device, the model's side with each
    module's vendor-fitted params."""
    impl = model_api.resolve_impl(impl).name
    dev = model.device
    trace, weight = trace.to(dev), weight.to(dev)
    if impl == "cuda":
        measure = fleet.fleet_measure_current_cuda
    else:
        sf = extract_structural_features(trace)   # shared by both sides

        def measure(tr, w, stacked):
            return fleet.fleet_measure_current(tr, w, stacked, sf=sf)
    vendor_order = list(model.vendors)
    rows = [vendor_order.index(s.vendor) for s in specs]
    est = measure(trace, weight, model.fleet.params.select(rows))
    truth = measure(trace, weight, true_stacked.to(dev))
    est = est.cpu().numpy().astype(np.float64)
    truth = truth.cpu().numpy().astype(np.float64)
    return float(np.mean(np.abs(est - truth) / np.maximum(truth, 1e-9)))
