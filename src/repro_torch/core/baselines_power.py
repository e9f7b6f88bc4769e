"""The datasheet-driven baseline power models the paper validates against
(Section 9.1), faithful to their documented flaws:

* Micron calculator (TN-41-01): worst-case IDD3N background whenever
  powered up, ACT/PRE at the *specification* row-cycle rate, RD/WR stacked
  on the background; no data dependency, no structural or process
  variation.
* DRAMPower: datasheet IDDs over the *actual* command timing, background
  interpolated between IDD2N and IDD3N by the open-bank count, RD/WR from
  IDD4R/IDD4W over the burst; no data dependency, no structural variation.

Exposed as the per-trace functions :func:`micron_power` /
:func:`drampower` and as :class:`MicronModel` / :class:`DRAMPowerModel`,
estimators of the unified protocol (``repro_torch.core.model_api``) that
hold a stacked ``(vendors, 10)`` IDD table on their device.  Neither
models data dependency or process variation, so ``mode='distribution'``
equals ``'mean'`` and ``mode='range'`` is ``(mean, mean, mean)``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import model_api
from repro_torch.core.dram import ACT, RD, WR, REF, CommandTrace, TIMING
from repro_torch.core.energy_model import (BG_ACTIVE, BG_PDN_ACT,
                                           BG_PDN_FAST, BG_PDN_SLOW,
                                           EnergyReport, StructuralFeatures,
                                           _report,
                                           extract_structural_features,
                                           masked_cycles, surface_charge,
                                           surface_cycles)
from repro_torch.kernels.common import batch_rows, row_sums

_T = TIMING

# datasheet keys the baseline formulas consume, in stacked-table order
BASELINE_IDD_KEYS = ("IDD0", "IDD2N", "IDD2P1", "IDD3N", "IDD4R", "IDD4W",
                     "IDD5B", "IDD2P0", "IDD3P", "IDD6")
_LOWPOWER_KEYS = ("IDD2P0", "IDD3P", "IDD6")


def with_lowpower_defaults(ds) -> dict:
    """Default the low-power keys a datasheet may lack to the fast
    power-down current IDD2P1."""
    out = dict(ds)
    for k in _LOWPOWER_KEYS:
        out.setdefault(k, out["IDD2P1"])
    return out


def _bg_state(sf: StructuralFeatures):
    """Per-command open-bank count and background-state code."""
    return sf.open_before.to(torch.float32).sum(dim=-1), sf.bg_state


def _bg_lut(bg_state, i_active, ds):
    """Background current from the state code (the datasheet twin of
    ``energy_model.background_current``)."""
    i_low = torch.where(bg_state == BG_PDN_FAST, ds["IDD2P1"],
                        torch.where(bg_state == BG_PDN_SLOW, ds["IDD2P0"],
                                    torch.where(bg_state == BG_PDN_ACT,
                                                ds["IDD3P"], ds["IDD6"])))
    return torch.where(bg_state == BG_ACTIVE, i_active, i_low)


def act_pair_charge(idd0, idd2n, idd3n):
    """ACT/PRE pair charge above the active background, from IDD0 at the
    specification row cycle — the one definition of this physics, shared
    with the baseline kernel's plain version."""
    return torch.clamp(
        (idd0 - (idd3n * _T.tRAS + idd2n * _T.tRP) / _T.tRC) * _T.tRC,
        min=0.0)


def _act_pair_charge(ds):
    return act_pair_charge(ds["IDD0"], ds["IDD2N"], ds["IDD3N"])


def micron_charges(trace: CommandTrace, open_banks, bg_state, ds):
    """Per-command charge (mA*cycles) of the TN-41-01-style estimate."""
    del open_banks  # the calculator's documented flaw: bank count ignored
    dt = trace.dt.to(torch.float32)
    i_bg = _bg_lut(bg_state, ds["IDD3N"], ds)
    charge = i_bg * dt
    any_act = (trace.cmd == ACT).any(dim=-1, keepdim=True)
    charge = charge + torch.where((bg_state == BG_ACTIVE) & any_act,
                                  _act_pair_charge(ds) * dt / _T.tRC, 0.0)
    burst = torch.clamp(dt, max=float(_T.tBURST))
    charge = charge + torch.where(trace.cmd == RD, ds["IDD4R"] * burst, 0.0)
    charge = charge + torch.where(trace.cmd == WR, ds["IDD4W"] * burst, 0.0)
    charge = charge + torch.where(
        trace.cmd == REF, (ds["IDD5B"] - ds["IDD2N"]) * _T.tRFC, 0.0)
    return charge


def drampower_charges(trace: CommandTrace, open_banks, bg_state, ds):
    """Per-command charge (mA*cycles) of the DRAMPower-style estimate."""
    dt = trace.dt.to(torch.float32)
    i_bg = _bg_lut(
        bg_state, ds["IDD2N"] + (ds["IDD3N"] - ds["IDD2N"]) * open_banks / 8.0,
        ds)
    charge = i_bg * dt
    charge = charge + torch.where(trace.cmd == ACT, _act_pair_charge(ds), 0.0)
    burst = torch.clamp(dt, max=float(_T.tBURST))
    charge = charge + torch.where(
        trace.cmd == RD, (ds["IDD4R"] - i_bg) * burst, 0.0)
    charge = charge + torch.where(
        trace.cmd == WR, (ds["IDD4W"] - i_bg) * burst, 0.0)
    charge = charge + torch.where(
        trace.cmd == REF, (ds["IDD5B"] - ds["IDD2N"]) * _T.tRFC, 0.0)
    return charge


_CHARGE_FNS = {"micron": micron_charges, "drampower": drampower_charges}


def _row_dict(row: torch.Tensor) -> dict:
    """One (10,) IDD row as a key -> scalar-tensor dict."""
    return {k: row[i] for i, k in enumerate(BASELINE_IDD_KEYS)}


def _datasheet_tensors(ds: dict, device) -> dict:
    ds = with_lowpower_defaults(ds)
    return {k: torch.tensor(ds[k], dtype=torch.float32, device=device)
            for k in BASELINE_IDD_KEYS}


def micron_power(trace: CommandTrace, ds: dict) -> EnergyReport:
    """TN-41-01-style estimate of one trace from datasheet IDDs."""
    ob, pd = _bg_state(extract_structural_features(trace))
    charge = micron_charges(trace, ob, pd,
                            _datasheet_tensors(ds, trace.device))
    return _report(charge.sum(), trace.total_cycles())


def drampower(trace: CommandTrace, ds: dict) -> EnergyReport:
    """DRAMPower-style estimate of one trace: datasheet IDDs, actual
    timing."""
    ob, pd = _bg_state(extract_structural_features(trace))
    charge = drampower_charges(trace, ob, pd,
                               _datasheet_tensors(ds, trace.device))
    return _report(charge.sum(), trace.total_cycles())


MODELS = {"micron": micron_power, "drampower": drampower}


# ---------------------------------------------------------------------------
# Batched dispatches (impl='vectorized')
# ---------------------------------------------------------------------------
def batched_baseline_reports(kind: str, trace: CommandTrace, weight,
                             table: torch.Tensor,
                             config: dict | None = None) -> EnergyReport:
    """Reports of every (trace, vendor) pair of one baseline kind;
    ``table`` is the stacked ``(vendors, 10)`` datasheet matrix;
    ``config`` places a sharded box in its batch
    (``kernels.common.batch_rows``)."""
    ob, pd = _bg_state(extract_structural_features(trace))
    rows = batch_rows(config)
    charge = torch.stack(
        [row_sums(_CHARGE_FNS[kind](trace, ob, pd, _row_dict(row)) * weight,
                  rows)
         for row in table], dim=-1)                           # (T, V)
    cycles = masked_cycles(trace, weight)
    return _report(charge, cycles[:, None].expand(charge.shape))


def batched_baseline_surface_reports(kind: str, trace: CommandTrace, weight,
                                     table: torch.Tensor,
                                     config: dict | None = None
                                     ) -> EnergyReport:
    """``mode='surface'`` twin: the same per-command charges grouped onto
    the (bank, row-band) cells -> ``(traces, vendors, banks, row_bands)``."""
    ob, pd = _bg_state(extract_structural_features(trace))
    rows = batch_rows(config)
    charge = torch.stack(
        [surface_charge(trace, weight,
                        _CHARGE_FNS[kind](trace, ob, pd, _row_dict(row)),
                        rows)
         for row in table], dim=1)                            # (T, V, 8, R)
    cycles = surface_cycles(trace, weight)
    return _report(charge, cycles[:, None].expand(charge.shape))


# ---------------------------------------------------------------------------
# Protocol estimators
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DatasheetModel(model_api.StackedEstimatorMixin):
    """Base of the baseline estimators: per-vendor datasheet IDD values as
    one stacked ``(V, 10)`` float32 table on ``device``."""
    datasheets: dict[int, dict[str, float]]
    device: torch.device = None  # type: ignore[assignment]

    kind = None  # class attribute, overridden per subclass

    def __post_init__(self):
        self.device = model_api.resolve_device(self.device)
        self.datasheets = {v: with_lowpower_defaults(d)
                           for v, d in self.datasheets.items()}
        self.idd_table = torch.tensor(
            [[self.datasheets[v][k] for k in BASELINE_IDD_KEYS]
             for v in sorted(self.datasheets)], dtype=torch.float32,
            device=self.device)

    @classmethod
    def from_datasheets(cls, datasheets: dict[int, dict[str, float]],
                        device=None):
        return cls(datasheets={v: dict(d) for v, d in datasheets.items()},
                   device=device)

    @classmethod
    def from_vampire(cls, model):
        """Share the fitted VAMPIRE model's derived per-vendor datasheets,
        on the model's device."""
        return cls.from_datasheets(model.datasheets(), device=model.device)

    @property
    def vendors(self) -> tuple[int, ...]:
        return tuple(sorted(self.datasheets))

    def to(self, device):
        return type(self).from_datasheets(self.datasheets, device=device)

    def _table_for(self, idx: tuple[int, ...]) -> torch.Tensor:
        if idx == tuple(range(self.idd_table.shape[0])):
            return self.idd_table
        return self._memo_subset(idx, lambda: self.idd_table[list(idx)])

    def estimate(self, traces, vendors=None, *,
                 mode: model_api.EstimateMode = "mean",
                 impl: str = "vectorized", data=None,
                 ones_frac=None, toggle_frac=None, config=None):
        """The unified entry point (``repro_torch.core.model_api``).
        ``impl`` is ``'vectorized'``, ``'cuda'`` (the baseline charge
        kernel, launched at ``config``) or ``'reference'`` (the per-trace
        functions)."""
        profile = model_api.normalize_data_profile(data, ones_frac,
                                                   toggle_frac)
        model_api.validate_data_profile(mode, profile)
        impl = model_api.resolve_impl(impl, mode=mode).name
        model_api.require_impl_path(self.kind, impl,
                                    ("vectorized", "cuda", "reference"))
        _, idx = model_api.resolve_vendor_indices(self.vendors, vendors)
        tb = self._batch_cache.get(traces)
        table = self._table_for(idx)
        if mode == "surface":
            if impl == "vectorized":
                return batched_baseline_surface_reports(
                    self.kind, tb.trace, tb.weight, table, config)
            if impl == "cuda":
                from repro_torch.kernels.baseline_energy import ops as bops
                charge, cycles = bops.baseline_charge_matrix(
                    tb.trace, tb.weight, table, self.kind, surface=True,
                    config=config)
                return _report(charge, cycles[:, None].expand(charge.shape))
            return self._reference_surface(traces, tb, idx)
        if impl == "vectorized":
            rep = batched_baseline_reports(self.kind, tb.trace, tb.weight,
                                           table, config)
        elif impl == "cuda":
            from repro_torch.kernels.baseline_energy import ops as bops
            charge, cycles = bops.baseline_charge_matrix(
                tb.trace, tb.weight, table, self.kind, config=config)
            rep = _report(charge, cycles[:, None].expand(charge.shape))
        else:
            rep = self._reference_matrix(traces, tb, idx)
        if mode == "range":
            return rep, rep, rep
        return rep

    def _reference_surface(self, traces, tb, idx) -> EnergyReport:
        """``impl='reference'`` for ``mode='surface'``: the per-trace
        charge formulas grouped onto the cells, one pair at a time."""
        from repro_torch.core.estimate_batch import original_traces
        order = self.vendors
        charge_fn = _CHARGE_FNS[self.kind]
        per_trace = []
        for tr in original_traces(traces, tb):
            tr = tr.to(self.device)
            ob, pd = _bg_state(extract_structural_features(tr))
            w = torch.ones(tr.n, dtype=torch.float32, device=self.device)
            pairs = [_report(
                surface_charge(tr, w, charge_fn(tr, ob, pd, _datasheet_tensors(
                    self.datasheets[order[j]], self.device))),
                surface_cycles(tr, w)) for j in idx]
            per_trace.append(model_api.stack_reports(pairs))
        return model_api.stack_reports(per_trace)

    def _reference_matrix(self, traces, tb, idx) -> EnergyReport:
        """``impl='reference'``: ``micron_power``/``drampower``, one call
        per (trace, vendor)."""
        from repro_torch.core.estimate_batch import original_traces
        order = self.vendors
        fn = MODELS[self.kind]
        return model_api.stack_reports([
            model_api.stack_reports(
                [fn(tr.to(self.device), self.datasheets[order[j]])
                 for j in idx])
            for tr in original_traces(traces, tb)])

    def save(self, path: str, *, meta: dict | None = None):
        model_api.save_estimator(self, path, meta=meta)

    @classmethod
    def load(cls, path: str, device=None):
        model = model_api.load_estimator(path, device=device)
        if not isinstance(model, cls):
            raise TypeError(f"{path} holds a {type(model).__name__}, "
                            f"not a {cls.__name__}")
        return model


@dataclasses.dataclass
class MicronModel(DatasheetModel):
    kind = "micron"


@dataclasses.dataclass
class DRAMPowerModel(DatasheetModel):
    kind = "drampower"


BASELINE_MODELS = {"micron": MicronModel, "drampower": DRAMPowerModel}
