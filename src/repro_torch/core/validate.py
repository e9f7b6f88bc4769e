"""Model validation (paper Section 9.1), in PyTorch.

Runs the paper's held-out validation workload — {ACT, n x RD, PRE} sweeps
with n in [0, 764], data 0xAA, bank 0 / row 128, column-interleaved — on a
randomly selected subset of modules (8 from Vendor A, 7 from B, 7 from C),
and reports the mean absolute percentage error (MAPE) of VAMPIRE,
DRAMPower and the Micron power model against the 'measured' current.

Every model is scored through the unified estimator protocol
(``repro_torch.core.model_api``): the whole (sweep x vendor) prediction
grid of each estimator is ONE ``estimate`` call over a shared padded
``TraceBatch`` through ``impl``.  The fleet's ground-truth measurements
are one padded probe batch through ``fleet.run_probes`` (the same
``impl``) with stable per-sweep noise keys.  A port of
``repro.core.validate``; Fig 14 reads each vendor's measured IDD currents
from the model's campaign arrays (``Vampire.saved``), which a fresh fit
and a loaded file both carry.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import characterize, device_sim, dram, idd_loops
from repro_torch.core import fleet as fleet_lib
from repro_torch.core.baselines_power import DRAMPowerModel, MicronModel
from repro_torch.core.dram import host_array as _host
from repro_torch.core.estimate_batch import TraceBatch
from repro_torch.core.model_api import Estimator

# n values swept in the validation experiments (paper: 0..764)
N_READS = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 48, 64, 96, 128,
           192, 256, 382, 512, 764)
VALIDATION_COUNTS = {0: 8, 1: 7, 2: 7}  # modules per vendor (paper Sec 9.1)

# noise-key base for the validation sweeps: disjoint from the campaign's
# IDD (0+) and probe (4096+) key ranges so validation measurements never
# reuse a campaign measurement's noise draw
_VALIDATION_KEY_BASE = 1 << 14


@dataclasses.dataclass
class ValidationResult:
    mape: dict[str, dict[int, float]]        # model -> vendor -> MAPE %
    mape_mean: dict[str, float]              # model -> mean across vendors
    raw: dict                                 # per (vendor, n): all numbers

    def summary(self) -> str:
        lines = ["model      MAPE(A)  MAPE(B)  MAPE(C)   mean"]
        for m, per_v in self.mape.items():
            lines.append(
                f"{m:10s} {per_v.get(0, float('nan')):7.1f}% "
                f"{per_v.get(1, float('nan')):7.1f}% "
                f"{per_v.get(2, float('nan')):7.1f}% "
                f"{self.mape_mean[m]:6.1f}%")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Structural-variation surfaces (paper Section 6, Figs 19-22 as fleet maps)
# ---------------------------------------------------------------------------
def surface_sweep_trace(reps: int = 4) -> dram.CommandTrace:
    """A workload touching every (bank, row-band) structural cell — one
    ACT/RD/PRE visit per cell at the surface campaign's constant-popcount
    probe rows — so a ``mode='surface'`` report over it populates the whole
    Fig 19-22 heatmap."""
    from repro_torch.core.dram import ACT, PRE, RD, TIMING, line_from_byte
    cmds, banks, rows, cols, datas, dts = [], [], [], [], [], []
    d = line_from_byte(0xAA)
    z = np.zeros(dram.LINE_WORDS, dtype=np.uint32)
    for b in range(dram.N_BANKS):
        for band in range(dram.N_ROW_BANDS):
            r = characterize.surface_probe_row(band)
            cmds += [ACT, RD, PRE]
            banks += [b] * 3
            rows += [r] * 3
            cols += [0] * 3
            datas += [z, d, z]
            dts += [TIMING.tRCD, TIMING.tRAS - TIMING.tRCD, TIMING.tRP]
    tr = dram.make_trace(cmds, banks, rows, cols, np.stack(datas), dts)
    return dram.tile_trace(tr, reps)


def structural_surface_maps(model: Estimator, traces=None, vendors=None,
                            impl: str = "vectorized") -> np.ndarray:
    """Fleet-wide Fig 19-22 heatmaps from the ``mode='surface'`` output:
    per-vendor (banks, row_bands) energy shares, normalized so each
    vendor's surface sums to 1.  ``traces`` defaults to
    :func:`surface_sweep_trace`; any estimator kind works — the baselines
    render structurally flat maps, which is the paper's contrast."""
    if traces is None:
        traces = [surface_sweep_trace()]
    rep = model.estimate(traces, vendors, mode="surface", impl=impl)
    energy = _host(rep.energy_pj).astype(np.float64).sum(axis=0)  # (V, 8, R)
    return energy / energy.sum(axis=(1, 2), keepdims=True)


def render_surface_heatmap(surface: np.ndarray, title: str = "") -> str:
    """ASCII rendering of one (banks, row_bands) surface, normalized to
    its own mean (1.00 == structurally flat cell)."""
    surface = np.asarray(surface, np.float64)
    rel = surface / surface.mean()
    lines = [title] if title else []
    lines.append("bank\\band " + " ".join(f"{b:>5d}"
                                          for b in range(surface.shape[1])))
    for b in range(surface.shape[0]):
        lines.append(f"  bank {b}  " + " ".join(f"{v:5.2f}"
                                                for v in rel[b]))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Measured vs. datasheet (paper Section 4 / Fig 14)
# ---------------------------------------------------------------------------
def measured_over_datasheet(model) -> dict[int, dict[str, float]]:
    """Paper Fig 14: per-vendor measured/datasheet ratio of every IDD key
    the campaign ran — the low-power keys (IDD2P1, IDD2P0, IDD3P, IDD6)
    included, which is the figure's headline: the low-power states sit
    far below their worst-case datasheet values (roughly 50-80% of them),
    so datasheet-driven models overestimate idle-heavy workloads most.

    Reads the campaign's arrays the model carries (``model.saved``: the
    ``raw/<vendor>/idd_measured/<key>`` currents and the float64
    ``idd_datasheet`` table), from a fresh fit or a loaded file; a model
    without them (a file written without raw campaign data) raises."""
    saved = getattr(model, "saved", None)
    if saved is None or not saved.raw:
        raise ValueError(
            "measured_over_datasheet needs the campaign's measured IDD "
            "currents (raw/<vendor>/idd_measured/<key>); this model carries "
            "no raw campaign arrays — fit it with model_api.fit or load a "
            "file saved from a fresh fit")
    arrays = saved.arrays
    vendor_ids = [int(v) for v in arrays["vendor_ids"]]
    out: dict[int, dict[str, float]] = {}
    for i, v in enumerate(vendor_ids):
        ds = dict(zip(model.idd_keys, arrays["idd_datasheet"][i].tolist()))
        out[v] = {}
        for k in characterize.IDD_KEYS:
            measured = arrays.get(f"raw/{v}/idd_measured/{k}")
            if measured is not None and ds.get(k, 0.0) > 0:
                out[v][k] = float(np.mean(measured)) / ds[k]
    return out


def render_fig14_table(ratios: dict[int, dict[str, float]]) -> str:
    """ASCII rendering of the Fig 14 ratios, one row per IDD key."""
    vendors = sorted(ratios)
    keys = [k for k in ratios[vendors[0]]]
    lines = ["IDD key   " + " ".join(f"  {'ABC'[v]}  " for v in vendors)]
    for k in keys:
        lines.append(f"{k:8s} " + " ".join(
            f"{ratios[v].get(k, float('nan')):5.2f}" for v in vendors))
    return "\n".join(lines)


def select_validation_modules(fleet_modules=None, seed: int = 42):
    fleet_modules = (device_sim.make_fleet() if fleet_modules is None
                     else fleet_modules)
    rng = np.random.default_rng(seed)
    chosen = []
    for v, k in VALIDATION_COUNTS.items():
        mods = device_sim.vendor_modules(fleet_modules, v)
        k = min(k, len(mods))
        idx = rng.choice(len(mods), size=k, replace=False)
        chosen += [mods[i] for i in idx]
    return chosen


def default_estimators(model) -> dict[str, Estimator]:
    """The paper's comparison set: the fitted VAMPIRE model plus both
    datasheet baselines built from its derived per-vendor datasheets."""
    return {"vampire": model,
            "drampower": DRAMPowerModel.from_vampire(model),
            "micron": MicronModel.from_vampire(model)}


def run_validation(model, fleet=None, n_values=N_READS, seed: int = 42,
                   estimators: dict[str, Estimator] | None = None,
                   impl: str = "vectorized") -> ValidationResult:
    """Score ``estimators`` (default: VAMPIRE + Micron + DRAMPower built
    from ``model``) against held-out fleet measurements on the model's
    device, every ``estimate`` and the measurement through ``impl``.  Any
    object implementing the estimator protocol can ride along — each
    one's full (sweep x vendor) grid is a single batched call."""
    modules = select_validation_modules(fleet, seed=seed)
    if estimators is None:
        estimators = default_estimators(model)

    n_values = list(n_values)
    sweeps = [idd_loops.validation_sweep(n) for n in n_values]
    vendors = sorted({m.spec.vendor for m in modules})

    # ---- every estimator: the whole (sweep x vendor) grid, one call ------
    batch = TraceBatch.from_traces(sweeps).to(model.device)
    grids = {name: _host(est.estimate(batch, vendors,
                                      impl=impl).avg_current_ma
                         ).astype(np.float64)
             for name, est in estimators.items()}        # each (S, V)

    # ---- ground truth: one padded probe batch over the held-out modules --
    points = [fleet_lib.ProbePoint(("validation", n), tr, 0,
                                   _VALIDATION_KEY_BASE + i)
              for i, (n, tr) in enumerate(zip(n_values, sweeps))]
    measured_mat = fleet_lib.run_probes(modules, points, engine="batched",
                                        impl=impl, device=model.device)

    vcol = {v: j for j, v in enumerate(vendors)}
    raw = {}
    errs: dict[str, dict[int, list[float]]] = {
        name: {v: [] for v in vendors} for name in grids}
    for mi, m in enumerate(modules):
        v = m.spec.vendor
        for i, n in enumerate(n_values):
            measured = float(measured_mat[mi, i])
            raw[(v, m.spec.module_id, n)] = {
                "measured": measured,
                **{name: float(grids[name][i, vcol[v]]) for name in grids}}
            for name in grids:
                errs[name][v].append(
                    abs(float(grids[name][i, vcol[v]]) - measured)
                    / measured * 100.0)

    mape = {name: {v: float(np.mean(e)) for v, e in per_v.items() if e}
            for name, per_v in errs.items()}
    mape_mean = {name: float(np.mean(list(per_v.values())))
                 for name, per_v in mape.items()}
    return ValidationResult(mape=mape, mape_mean=mape_mean, raw=raw)
