"""VAMPIRE — the Variation-Aware model of Memory Power Informed by Real
Experiments (paper Section 9) — as a fitted model on a device.

The fitted state is a :class:`FleetModel`: per-vendor ``PowerParams``
stacked along a leading vendor axis, the variation bands, the datasheet
IDD table and the vendor ids, all tensors on one device.  A model comes
from the characterization campaign (``Vampire.fit(fleet)``, a thin call
into ``model_api.fit('vampire', fleet, fitter='campaign')``) or from a
schema-v2 file (``model_api.load_estimator``).

``model.estimate(traces, vendors=None, *, mode=, impl=, data=)`` is the
unified entry point (``repro_torch.core.model_api``): ``'mean'``,
``'range'`` (lo, mean, hi across each vendor's band), ``'distribution'``
(expected ones/toggle fractions instead of data) and ``'surface'``
(per-(bank, row-band) decomposition), through ``impl='vectorized'``,
``'cuda'`` or ``'reference'``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import model_api
from repro_torch.core.energy_model import (EnergyReport, PowerParams,
                                           _report, charge_from_features,
                                           distribution_features,
                                           extract_structural_features,
                                           finalize_features, scale_report,
                                           surface_charge, surface_cycles,
                                           trace_charges_scan,
                                           trace_energy_scan)
from repro_torch.core.fleet import stack_params


class FleetModel(NamedTuple):
    """The fitted state; every leaf carries a leading vendor axis."""
    params: PowerParams           # stacked (V, ...) fitted params
    band: torch.Tensor            # (V, 2) multiplicative (lo, hi) variation
    idd_datasheet: torch.Tensor   # (V, K) datasheet IDDs (keys: idd_keys)
    vendor_ids: torch.Tensor      # (V,) int32

    def to(self, device) -> "FleetModel":
        return FleetModel(self.params.to(device), self.band.to(device),
                          self.idd_datasheet.to(device),
                          self.vendor_ids.to(device))


@dataclasses.dataclass
class Vampire(model_api.StackedEstimatorMixin):
    """A fitted VAMPIRE model: a :class:`FleetModel` plus the key order of
    its datasheet table.  A model loaded from a file also keeps, as host
    numpy, what the file held (``saved``: the float64 fitted arrays, the
    raw campaign arrays and the manifest's R^2 maps), so saving it writes
    the file back unchanged; estimates read only the fleet's float32
    leaves.

    ``vendor_order`` is the vendor ids as a Python tuple, fixed when the
    model is built (read once from ``fleet.vendor_ids`` when not given):
    ``vendors``, ``params`` and ``datasheets`` read it, so no dispatch
    copies the ids back from the card."""
    fleet: FleetModel
    idd_keys: tuple[str, ...]
    saved: model_api.SavedFit | None = None
    vendor_order: tuple[int, ...] | None = None

    kind = "vampire"

    def __post_init__(self):
        if self.vendor_order is None:
            self.vendor_order = tuple(
                int(v) for v in self.fleet.vendor_ids.tolist())
        else:
            self.vendor_order = tuple(int(v) for v in self.vendor_order)

    @property
    def device(self) -> torch.device:
        return self.fleet.band.device

    @property
    def vendors(self) -> tuple[int, ...]:
        return self.vendor_order

    def params(self, vendor: int) -> PowerParams:
        """One vendor's fitted parameters (its row of the stacked
        leaves)."""
        try:
            i = self.vendors.index(int(vendor))
        except ValueError:
            raise KeyError(vendor) from None
        return self.fleet.params.select(i)

    def to(self, device) -> "Vampire":
        return Vampire(self.fleet.to(model_api.resolve_device(device)),
                       self.idd_keys, self.saved, self.vendor_order)

    def datasheets(self) -> dict[int, dict[str, float]]:
        """Per-vendor datasheet IDDs (what the baselines consume)."""
        table = self.fleet.idd_datasheet.cpu().tolist()
        return {v: dict(zip(self.idd_keys, row))
                for v, row in zip(self.vendors, table)}

    def _stacked_for(self, idx: tuple[int, ...]):
        """(stacked params, band) rows of the requested vendor indices."""
        fm = self.fleet
        if idx == tuple(range(fm.band.shape[0])):
            return fm.params, fm.band
        return self._memo_subset(
            idx, lambda: (fm.params.select(list(idx)), fm.band[list(idx)]))

    # ------------------------------------------------------------------ fit
    @classmethod
    def fit(cls, fleet=None, **kw) -> "Vampire":
        """Run the characterization campaign and build the model:
        ``model_api.fit('vampire', fleet, fitter='campaign', **kw)``
        (``device=``, ``engine='batched'|'serial'``,
        ``impl='vectorized'|'cuda'``, ``probe_modules``, ``probe_reps``,
        ``n_rows``)."""
        return model_api.fit("vampire", fleet, fitter="campaign", **kw)

    @classmethod
    def from_characterization(cls, by_vendor: dict, device) -> "Vampire":
        """The model of a campaign's per-vendor records
        (``characterize.VendorCharacterization``) on ``device``.  Each
        vendor's variation band is the (min, max) of its modules' IDD0,
        IDD4R and IDD4W currents over their means; ``saved`` keeps the
        float64 fitted quantities and the raw campaign arrays, so ``save``
        writes the file the reference writes."""
        vs = sorted(by_vendor)
        bands = {}
        for v in vs:
            rel = np.concatenate(
                [arr / np.mean(arr) for arr in
                 (by_vendor[v].idd_measured[k]
                  for k in ("IDD0", "IDD4R", "IDD4W"))])
            bands[v] = (float(np.min(rel)), float(np.max(rel)))
        idd_keys = tuple(sorted(by_vendor[vs[0]].idd_datasheet))
        fleet = FleetModel(
            params=stack_params([by_vendor[v].build_params(device)
                                 for v in vs]),
            band=torch.tensor([bands[v] for v in vs], dtype=torch.float32,
                              device=device),
            idd_datasheet=torch.tensor(
                [[by_vendor[v].idd_datasheet[k] for k in idd_keys]
                 for v in vs], dtype=torch.float32, device=device),
            vendor_ids=torch.tensor(vs, dtype=torch.int32, device=device))
        return cls(fleet, idd_keys,
                   model_api.saved_fit_from_campaign(by_vendor, bands),
                   tuple(vs))

    # ------------------------------------------------------------- estimate
    def estimate(self, traces, vendors=None, *,
                 mode: model_api.EstimateMode = "mean",
                 impl: str = "vectorized", data=None,
                 ones_frac=None, toggle_frac=None):
        """The unified entry point (see the module docstring)."""
        from repro_torch.core import estimate_batch as eb
        profile = model_api.normalize_data_profile(data, ones_frac,
                                                   toggle_frac)
        model_api.validate_data_profile(mode, profile)
        ones_frac, toggle_frac = profile.ones_frac, profile.toggle_frac
        impl = model_api.resolve_impl(impl, mode=mode).name
        model_api.require_impl_path(self.kind, impl,
                                    ("vectorized", "cuda", "reference"))
        _, idx = model_api.resolve_vendor_indices(self.vendors, vendors)
        stacked, band = self._stacked_for(idx)
        tb = self._batch_cache.get(traces)

        if mode == "surface":
            if impl == "vectorized":
                return eb.batched_surface_reports(tb.trace, tb.weight,
                                                  stacked)
            if impl == "cuda":
                return eb.cuda_batched_surface_reports(tb.trace, tb.weight,
                                                       stacked)
            return self._reference_surface(traces, tb, stacked)

        if mode == "distribution":
            if impl == "vectorized":
                return eb.batched_distribution_reports(
                    tb.trace, tb.weight, stacked, ones_frac, toggle_frac)
            if impl == "cuda":
                return eb.cuda_batched_distribution_reports(
                    tb.trace, tb.weight, stacked, ones_frac, toggle_frac)
            return self._reference_matrix(traces, tb, stacked,
                                          ones_frac=ones_frac,
                                          toggle_frac=toggle_frac)

        if impl == "vectorized":
            if mode == "range":
                return eb.batched_range_reports(tb.trace, tb.weight, stacked,
                                                band)
            return eb.batched_reports(tb.trace, tb.weight, stacked)
        if impl == "cuda":
            if mode == "range":
                return eb.cuda_batched_range_reports(tb.trace, tb.weight,
                                                     stacked, band)
            return eb.cuda_batched_reports(tb.trace, tb.weight, stacked)
        mean = self._reference_matrix(traces, tb, stacked)
        if mode == "mean":
            return mean
        return (scale_report(mean, band[None, :, 0]), mean,
                scale_report(mean, band[None, :, 1]))

    def _reference_matrix(self, traces, tb, stacked: PowerParams, *,
                          ones_frac=None, toggle_frac=None) -> EnergyReport:
        """``impl='reference'``: the pair-at-a-time oracle — the
        command-by-command walk for measured-data modes, the per-trace
        feature override for ``mode='distribution'``."""
        from repro_torch.core.estimate_batch import original_traces
        originals = [tr.to(self.device)
                     for tr in original_traces(traces, tb)]
        vendors = [stacked.select(v) for v in range(stacked.i2n.shape[0])]
        if ones_frac is not None:
            of = np.broadcast_to(np.asarray(ones_frac, np.float32),
                                 (len(originals),))
            tf = np.broadcast_to(np.asarray(toggle_frac, np.float32),
                                 (len(originals),))

            def one_pair(i, tr, pp):
                sf = distribution_features(extract_structural_features(tr),
                                           float(of[i]), float(tf[i]))
                charges = charge_from_features(
                    tr, finalize_features(sf, pp), pp)
                return _report(charges.sum(), tr.total_cycles())

            rows = [[one_pair(i, tr, pp) for pp in vendors]
                    for i, tr in enumerate(originals)]
        else:
            rows = [[trace_energy_scan(tr, pp) for pp in vendors]
                    for tr in originals]
        return model_api.stack_reports(
            [model_api.stack_reports(r) for r in rows])

    def _reference_surface(self, traces, tb, stacked: PowerParams
                           ) -> EnergyReport:
        """``impl='reference'`` for ``mode='surface'``: the oracle's
        per-command charges grouped onto the cells, pair by pair."""
        from repro_torch.core.estimate_batch import original_traces

        def one_pair(tr, pp):
            charges = trace_charges_scan(tr, pp)
            w = torch.ones_like(charges)
            return _report(surface_charge(tr, w, charges),
                           surface_cycles(tr, w))

        rows = []
        for tr in original_traces(traces, tb):
            tr = tr.to(self.device)
            rows.append(model_api.stack_reports(
                [one_pair(tr, stacked.select(v))
                 for v in range(stacked.i2n.shape[0])]))
        return model_api.stack_reports(rows)

    # ------------------------------------------------------------------ io
    def save(self, path: str, *, meta: dict | None = None):
        """Schema-v2 ``.npz`` + JSON manifest (readable by the reference
        package's loader)."""
        model_api.save_estimator(self, path, meta=meta)

    @classmethod
    def load(cls, path: str, device=None) -> "Vampire":
        model = model_api.load_estimator(path, device=device)
        if not isinstance(model, cls):
            raise TypeError(f"{path} holds a {type(model).__name__}, "
                            "not a Vampire model")
        return model


def reference_vampire(device=None) -> Vampire:
    """A quick-fit VAMPIRE on a reduced fleet (3 vendors x 3 modules, 2
    probe modules, 64 probe repetitions, 8 rows) on ``device`` (``cuda``
    unless the caller names another): the counterpart of the reference's
    ``reference_vampire``, for tests and the analysis gate."""
    from repro_torch.core import device_sim
    from repro_torch.core import params as P
    fleet = device_sim.make_fleet(
        [P.ModuleSpec(v, i, 2015) for v in range(3) for i in range(3)])
    return Vampire.fit(fleet, device=device, probe_modules=2,
                       probe_reps=64, n_rows=8)
