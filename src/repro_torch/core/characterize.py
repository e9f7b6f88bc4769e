"""The full characterization campaign (paper Sections 4-6) and VAMPIRE fit.

Pipeline (mirrors the paper's methodology):

1. Run each JEDEC IDD loop on every module in the fleet -> per-module
   measured currents, per-vendor distributions (Section 4).
2. Derive the *datasheet* values the vendor would publish: vendor-mean loop
   current divided by the paper's measured/datasheet ratios, published at
   1066/1333/1600 MT/s, then extrapolated back to 800 MT/s by linear
   least squares exactly as in Section 4 (Eq. 1).
3. Data-dependency sweeps (Section 5): ones sweeps and same-ones/controlled-
   toggle pair sweeps for each interleaving mode and op; fit Eq. 2 per
   (mode, op) with the I/O-driver estimate subtracted -> Table 5 recovery.
4. Structural probes (Section 6): per-bank idle/read/write, per-row
   activation, per-column read, and the per-(bank, row-band) SURFACE
   campaign — one constant-row-popcount ACT/PRE loop per surface cell, so
   current differences across cells isolate the planted structural surface
   from the row-address-ones slope (Figs 19-22 recovery).
5. Assemble fitted per-vendor :class:`PowerParams` -> the VAMPIRE model.

This is the port of ``repro.core.characterize``: the campaign's plan, noise
keys and inversions are the reference's; the measurements run on a device
through ``repro_torch.core.fleet`` (``impl='vectorized'`` or ``'cuda'``).

Every measurement of the campaign is declared up front as a
:class:`CampaignPlan` of probe points, which either engine can execute:
``engine='batched'`` (default) evaluates padded fixed-shape probe batches
against all modules in two dispatches per vendor (see
``repro_torch.core.fleet``); ``engine='serial'`` replays the campaign one
``measure_current`` call at a time and serves as the correctness oracle —
both draw identical per-(module, probe) measurement noise, so they fit the
same parameters to float32 tolerance.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

import torch

from repro_torch.core import device_sim, dram, fitting, fleet, idd_loops
from repro_torch.core import model_api
from repro_torch.core import params as P
from repro_torch.core.dram import RD, WR, LINE_BITS
from repro_torch.core.energy_model import PowerParams, trace_energy_vectorized
from repro_torch.core.fleet import ProbeBatch, ProbePoint

# low-power keys appended at the END so pre-existing loops keep their
# stable noise-key indices (a key IS the measurement's noise draw).
IDD_KEYS = ("IDD2N", "IDD3N", "IDD0", "IDD1", "IDD4R", "IDD4W", "IDD7",
            "IDD5B", "IDD2P1", "IDD2P0", "IDD3P", "IDD6")
IL_MODES = ("none", "col", "bank", "bankcol")
OPS = (RD, WR)

ONES_POINTS = (0, 64, 128, 192, 256, 320, 384, 448, 512)
PAIR_ONES = (64, 128, 192, 256, 320, 384, 448)
PAIR_TOGGLES = (0, 32, 64, 128, 192, 256)

# stable noise-key bases: IDD loops and probe-subset points must never share
# a key (a key IS the measurement's noise draw, per module)
_IDD_KEY_BASE = 0
_PROBE_KEY_BASE = 4096


def _feasible(n_ones: int, togg: int) -> bool:
    h = togg // 2
    return h <= n_ones and h <= LINE_BITS - n_ones


def pair_lines(n_ones: int, togg: int, seed: int = 0):
    """Two 512-bit lines, each with ``n_ones`` ones, differing in exactly
    ``togg`` bit positions (flip togg/2 ones and togg/2 zeros)."""
    rng = np.random.default_rng(seed + 7919 * n_ones + togg)
    a_bits = np.zeros(LINE_BITS, dtype=np.uint8)
    on = rng.choice(LINE_BITS, size=n_ones, replace=False)
    a_bits[on] = 1
    b_bits = a_bits.copy()
    h = togg // 2
    ones_idx = np.flatnonzero(a_bits == 1)
    zeros_idx = np.flatnonzero(a_bits == 0)
    b_bits[rng.choice(ones_idx, size=h, replace=False)] = 0
    b_bits[rng.choice(zeros_idx, size=h, replace=False)] = 1
    return dram.pack_bits(a_bits), dram.pack_bits(b_bits)


# ---------------------------------------------------------------------------
# Datasheet derivation ("what the vendor publishes")
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def derive_datasheets() -> dict[int, dict[str, float]]:
    """Per-vendor datasheet IDD values at 800 MT/s, derived so that the
    vendor-mean *true* loop current over datasheet equals the paper's
    Section 4 ratios. Independent of measurement noise by construction
    (twelve short loops a vendor, computed once, on the host)."""
    out: dict[int, dict[str, float]] = {}
    for v in range(3):
        pp = device_sim.true_vendor_params(v)
        ds = {}
        for key in IDD_KEYS:
            loop = idd_loops.IDD_LOOPS[key]()
            true_mean = float(trace_energy_vectorized(loop, pp).avg_current_ma)
            ds[key] = true_mean / P.MEASURED_OVER_DATASHEET[key][v]
        out[v] = ds
    return out


def published_freq_tables() -> dict[int, dict[str, np.ndarray]]:
    """Datasheet IDD tables at 1066/1333/1600 MT/s per vendor."""
    ds = derive_datasheets()
    return {v: {k: fitting.synth_datasheet_freq_table(
                    ds[v][k], seed=100 * v + i)
                for i, k in enumerate(IDD_KEYS)}
            for v in ds}


def extrapolated_datasheets() -> tuple[dict[int, dict[str, float]],
                                       dict[int, dict[str, float]]]:
    """Fit the published frequency tables back to 800 MT/s (Section 4's
    procedure). Returns (values, r2s)."""
    tables = published_freq_tables()
    vals: dict[int, dict[str, float]] = {}
    r2s: dict[int, dict[str, float]] = {}
    for v, t in tables.items():
        vals[v], r2s[v] = {}, {}
        for k, freq_vals in t.items():
            i800, r2 = fitting.extrapolate_idd_to_800(freq_vals)
            vals[v][k] = i800
            r2s[v][k] = r2
    return vals, r2s


# ---------------------------------------------------------------------------
# Campaign result containers
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class VendorCharacterization:
    vendor: int
    idd_measured: dict[str, np.ndarray]          # per-module currents
    idd_datasheet: dict[str, float]              # extrapolated to 800 MT/s
    idd_extrapolation_r2: dict[str, float]
    datadep: np.ndarray                          # (4 modes, 2 ops, 3) fitted
    datadep_r2: np.ndarray                       # (4, 2)
    ones_sweep: dict                             # raw sweep data for benches
    i2n: float
    bank_open_delta: np.ndarray                  # (8,)
    bank_read_factor: np.ndarray                 # (8,)
    bank_write_factor: np.ndarray                # (8,)
    q_actpre: float
    row_ones_slope: float
    row_sweep: dict
    q_ref: float
    i_pd: float
    # rest of the background-state LUT (Section 4.2 / Fig 14); None for
    # pre-lattice model blobs -> fall back to the fast power-down current
    i_pd_slow: float = None  # type: ignore[assignment]
    i_actpd: float = None  # type: ignore[assignment]
    i_sr: float = None  # type: ignore[assignment]
    # per-(bank, row-band) structural surface recovered by the surface
    # campaign; None (-> neutral all-ones) for pre-surface model blobs
    act_surface: np.ndarray = None  # type: ignore[assignment]
    fitted: PowerParams = None  # type: ignore[assignment]

    def build_params(self, device="cpu") -> PowerParams:
        """The fitted float32 ``PowerParams`` on ``device`` (kept as
        ``fitted``)."""
        if self.act_surface is None:
            self.act_surface = np.ones((dram.N_BANKS, dram.N_ROW_BANDS))

        def t(x):
            return torch.tensor(np.asarray(x, np.float64), dtype=torch.float32,
                                device=device)

        self.fitted = PowerParams(
            datadep=t(self.datadep), i2n=t(self.i2n),
            bank_open_delta=t(self.bank_open_delta),
            bank_read_factor=t(self.bank_read_factor),
            bank_write_factor=t(self.bank_write_factor),
            q_actpre=t(self.q_actpre), row_ones_slope=t(self.row_ones_slope),
            q_ref=t(self.q_ref), i_pd=t(self.i_pd),
            io_read_ma_per_one=t(P.IO_DRIVER_MA_PER_ONE_READ),
            io_write_ma_per_zero=t(P.IO_DRIVER_MA_PER_ZERO_WRITE),
            ones_quad=t(0.0),  # the model is linear
            act_surface=t(self.act_surface),
            i_pd_slow=t(self.i_pd if self.i_pd_slow is None
                        else self.i_pd_slow),
            i_actpd=t(self.i_pd if self.i_actpd is None else self.i_actpd),
            i_sr=t(self.i_pd if self.i_sr is None else self.i_sr))
        return self.fitted


def _io_estimate(op: int, ones: np.ndarray) -> np.ndarray:
    """The paper's 'conservative estimate' of rig-visible I/O current."""
    ones = np.asarray(ones, dtype=np.float64)
    if op == RD:
        return P.IO_DRIVER_MA_PER_ONE_READ * ones
    return P.IO_DRIVER_MA_PER_ZERO_WRITE * (LINE_BITS - ones)


# ---------------------------------------------------------------------------
# The campaign plan: every probe point of the measurement campaign, with a
# stable noise key per point. The plan is vendor-independent (pair data and
# row samples depend only on rng_seed), so one plan — and its padded batched
# form — is shared across all three vendors and both engines.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CampaignPlan:
    idd_points: list[ProbePoint]    # measured on EVERY module of a vendor
    probe_points: list[ProbePoint]  # measured on the probe-module subset
    rows: list[int]                 # row addresses of the activation sweep

    @functools.cached_property
    def idd_batch(self) -> ProbeBatch:
        return ProbeBatch.from_points(self.idd_points)

    @functools.cached_property
    def probe_batch(self) -> ProbeBatch:
        return ProbeBatch.from_points(self.probe_points)

    def batch_on(self, name: str, device) -> ProbeBatch:
        """``idd_batch`` or ``probe_batch`` on ``device`` (copied there
        once)."""
        on = self.__dict__.setdefault("_on_device", {})
        key = (name, torch.device(device))
        if key not in on:
            on[key] = getattr(self, name).to(device)
        return on[key]


def _sample_rows(n_rows: int, rng_seed: int) -> list[int]:
    """Row addresses covering address popcounts 0..ROW_BAND_SHIFT, all
    inside row band 0 (bits below ``ROW_BAND_SHIFT``) so the row-ones
    slope fit is not confounded by the per-(bank, row-band) structural
    surface — band 0 is the surface's reference band (factor 1.0); the
    dedicated surface campaign covers the other bands at constant
    popcount."""
    rng = np.random.default_rng(rng_seed + 1)
    rows = []
    for ro in range(dram.ROW_BAND_SHIFT + 1):
        for _ in range(max(1, n_rows // (dram.ROW_BAND_SHIFT + 1))):
            bits = rng.choice(dram.ROW_BAND_SHIFT, size=ro, replace=False)
            rows.append(int(sum(1 << int(b) for b in bits)))
    return rows


# Every surface probe's row has this address popcount, so cell-to-cell
# current differences isolate the surface factor from the row-ones slope.
SURFACE_ROW_POPCOUNT = 3


def surface_probe_row(band: int) -> int:
    """The probe row of a surface band: band bits at the top, low bits
    padding the address popcount to :data:`SURFACE_ROW_POPCOUNT`."""
    pad = SURFACE_ROW_POPCOUNT - bin(band).count("1")
    return (band << dram.ROW_BAND_SHIFT) | ((1 << pad) - 1)


@functools.lru_cache(maxsize=4)
def campaign_plan(probe_reps: int = 256, n_rows: int = 24,
                  rng_seed: int = 0) -> CampaignPlan:
    idd_points = [
        ProbePoint(("idd", key), idd_loops.IDD_LOOPS[key](), 0,
                   _IDD_KEY_BASE + i)
        for i, key in enumerate(IDD_KEYS)]

    pts: list[tuple[tuple, dram.CommandTrace, int]] = []
    for mode in IL_MODES:
        for oi, op in enumerate(OPS):
            if mode == "none":
                for n1 in ONES_POINTS:
                    tr, skip = idd_loops.ones_sweep_point(n1, op=op,
                                                          reps=probe_reps)
                    pts.append((("sweep", mode, oi, n1, 0), tr, skip))
            else:
                for n1 in PAIR_ONES:
                    for tg in PAIR_TOGGLES:
                        if not _feasible(n1, tg):
                            continue
                        a, b = pair_lines(n1, tg, seed=rng_seed)
                        tr, skip = idd_loops.interleave_sweep_point(
                            a, b, mode, op=op, reps=probe_reps // 2)
                        pts.append((("sweep", mode, oi, n1, tg), tr, skip))
    pts.append((("i2n_probe",), idd_loops.idd2n(), 0))
    for b in range(8):
        tr, skip = idd_loops.bank_idle_probe(b)
        pts.append((("bank_idle", b), tr, skip))
    for oi, op in enumerate(OPS):
        for b in range(8):
            tr, skip = idd_loops.bank_read_probe(b, op=op, reps=probe_reps)
            pts.append((("bank_rw", oi, b), tr, skip))
    rows = _sample_rows(n_rows, rng_seed)
    for i, r in enumerate(rows):
        tr, skip = idd_loops.row_act_probe(r, reps=probe_reps)
        pts.append((("row", i), tr, skip))
    # surface campaign (appended LAST so earlier probes keep their noise
    # keys): one ACT/PRE loop per (bank, row-band) cell
    for b in range(dram.N_BANKS):
        for band in range(dram.N_ROW_BANDS):
            tr, skip = idd_loops.surface_act_probe(
                b, surface_probe_row(band), reps=probe_reps)
            pts.append((("surface", b, band), tr, skip))

    probe_points = [ProbePoint(label, tr, skip, _PROBE_KEY_BASE + i)
                    for i, (label, tr, skip) in enumerate(pts)]
    return CampaignPlan(idd_points, probe_points, rows)


# ---------------------------------------------------------------------------
# The campaign
# ---------------------------------------------------------------------------
def characterize_vendor(modules, vendor: int, *, probe_modules: int = 5,
                        probe_reps: int = 256, n_rows: int = 24,
                        rng_seed: int = 0, engine: str = "batched",
                        impl: str = "vectorized",
                        device=None) -> VendorCharacterization:
    """Measure one vendor's modules on ``device`` (``cuda`` unless the
    caller names another) and invert the campaign."""
    device = model_api.resolve_device(device)
    probes = modules[:probe_modules]
    plan = campaign_plan(probe_reps=probe_reps, n_rows=n_rows,
                         rng_seed=rng_seed)

    # ---- measurement: two batched dispatches (or the serial oracle) -------
    # ``impl`` picks the batched engine's evaluation path (plain PyTorch
    # or the kernels) through the shared impl registry
    batched = engine == "batched"
    idd_currents = fleet.run_probes(            # (all modules, 12 IDD loops)
        modules, plan.idd_points, engine=engine, impl=impl, device=device,
        batch=plan.batch_on("idd_batch", device) if batched else None)
    probe_currents = fleet.run_probes(          # (probe modules, all probes)
        probes, plan.probe_points, engine=engine, impl=impl, device=device,
        batch=plan.batch_on("probe_batch", device) if batched else None)
    probe_mean = probe_currents.mean(axis=0)
    cur = {pt.label: float(probe_mean[i])
           for i, pt in enumerate(plan.probe_points)}

    # ---- 1. IDD loops on every module ------------------------------------
    idd_measured = {key: idd_currents[:, i] for i, key in enumerate(IDD_KEYS)}
    return invert_campaign(plan, vendor, cur, idd_measured)


def invert_campaign(plan: CampaignPlan, vendor: int, cur: dict,
                    idd_measured: dict) -> VendorCharacterization:
    """The slot-accounting inversions: per-probe-cell mean currents (the
    campaign's, or a streaming fitter's decayed sufficient statistics) ->
    one fitted ``VendorCharacterization``.

    ``cur`` maps every probe-point label of ``plan`` to its mean current
    over the probe modules; ``idd_measured`` maps each IDD key to the
    per-module current vector of the vendor's whole module population.
    Host float64 numpy throughout, but for the least-squares fits, which
    are float32 as in the reference (``fitting.lstsq_fit``)."""
    ds_vals, ds_r2 = extrapolated_datasheets()

    # ---- 2. data-dependency fits (Section 5 / Table 5) --------------------
    datadep = np.zeros((4, 2, 3))
    datadep_r2 = np.zeros((4, 2))
    ones_sweep_raw = {}
    for mi, mode in enumerate(IL_MODES):
        for oi, op in enumerate(OPS):
            sweep = [(lab, c) for lab, c in cur.items()
                     if lab[0] == "sweep" and lab[1] == mode and lab[2] == oi]
            ones_a = np.asarray([lab[3] for lab, _ in sweep],
                                dtype=np.float64)
            tog_a = np.asarray([lab[4] for lab, _ in sweep],
                               dtype=np.float64)
            cur_a = np.asarray([c for _, c in sweep], dtype=np.float64)
            corrected = cur_a - _io_estimate(op, ones_a)
            fit = fitting.fit_ones_toggles(ones_a, tog_a, corrected)
            datadep[mi, oi] = fit.coef
            datadep_r2[mi, oi] = fit.r2
            ones_sweep_raw[(mode, "RD" if op == RD else "WR")] = {
                "ones": ones_a, "toggles": tog_a, "current": cur_a,
                "corrected": corrected,
            }
    # 'none' mode cannot expose toggling; pin its coefficient to 0.
    datadep[0, :, 2] = 0.0

    # ---- 3. structural probes (Section 6) ---------------------------------
    # The structural/background fits must use the *same* module population
    # as the probes (process variation otherwise biases the subtractions).
    i2n_probe = cur[("i2n_probe",)]
    i2n = float(np.mean(idd_measured["IDD2N"]))
    bank_idle = np.array([cur[("bank_idle", b)] for b in range(8)])
    bank_open_delta = np.maximum(bank_idle - i2n_probe, 0.05)

    rd_cur = np.array([cur[("bank_rw", 0, b)] for b in range(8)])
    wr_cur = np.array([cur[("bank_rw", 1, b)] for b in range(8)])
    bank_read_factor = rd_cur / rd_cur[0]
    bank_write_factor = wr_cur / wr_cur[0]

    # per-row activation sweep: rows chosen to cover address popcounts 0..15
    rows = plan.rows
    row_cur = np.array([cur[("row", i)] for i in range(len(rows))])
    row_ones = np.array([bin(r).count("1") for r in rows], dtype=np.float64)
    d = np.stack([np.ones_like(row_ones), row_ones], axis=1)
    rf = fitting.lstsq_fit(d, row_cur)
    # I(ro) = bg + q(1+s*ro)/tRC  =>  s = c1 / (c0 - bg).  Loop background
    # matches the integrator: bank closed during the ACT slot (tRAS), open
    # during the PRE slot (tRP) — same weighting as the surface fit below.
    t = dram.TIMING
    bg_loop = (i2n_probe * t.tRAS
               + (i2n_probe + bank_open_delta[0]) * t.tRP) / t.tRC
    q_actpre = max(float(rf.coef[0]) - bg_loop, 1.0) * t.tRC
    row_ones_slope = float(rf.coef[1]) * t.tRC / q_actpre

    # ---- 3b. surface campaign (Figs 19-22) --------------------------------
    # Every probe shares one row popcount, so within a bank the ACT part of
    # the loop current varies ONLY through the structural surface; band 0
    # is the reference (factor 1.0), exactly as the simulator plants it.
    # Loop background: the bank is closed during the ACT slot (tRAS) and
    # open during the PRE slot (tRP) — background follows the state BEFORE
    # each command, so the open-bank increment weights tRP, not tRAS.
    surf_cur = np.array(
        [[cur[("surface", b, band)] for band in range(dram.N_ROW_BANDS)]
         for b in range(dram.N_BANKS)])
    bg_bank = (i2n_probe * t.tRAS
               + (i2n_probe + bank_open_delta) * t.tRP) / t.tRC  # (8,)
    act_part = np.maximum(surf_cur - bg_bank[:, None], 1e-3)
    act_surface = np.clip(act_part / act_part[:, :1], 0.2, 5.0)

    # ---- 4. refresh & power-down ------------------------------------------
    idd5b = float(np.mean(idd_measured["IDD5B"]))
    q_ref = (idd5b - i2n) * float(t.tRFC)
    i_pd = float(np.mean(idd_measured["IDD2P1"]))

    # ---- 4b. low-power background states (Section 4.2 / Fig 14) -----------
    # IDD2P0's loop never powers back up (like IDD2P1), so after the first
    # entry the whole loop dwells in slow power-down — the direct mean IS
    # the fitted current.  IDD3P and IDD6 loops must power up every
    # repetition (ACT is illegal during power-down; self-refresh admits
    # only NOP/SRX), so the powered-up slots — billed at the state BEFORE
    # each command, like everywhere else in the integrator — are subtracted
    # analytically before dividing by the low-power dwell (which includes
    # the exit slot: PDX/SRX are the last slots billed at low-power rate).
    i_pd_slow = float(np.mean(idd_measured["IDD2P0"]))

    idle8 = idd_loops.IDLE_SLOT * 8
    idd3p_mean = float(np.mean(idd_measured["IDD3P"]))
    tot3p = t.tRCD + t.tCKE + idle8 + t.tXP + t.tRP
    up3p = (i2n * t.tRCD
            + (i2n + float(bank_open_delta[0])) * (t.tCKE + t.tRP)
            + q_actpre)
    i_actpd = max((idd3p_mean * tot3p - up3p) / (idle8 + t.tXP), 0.1)

    idd6_mean = float(np.mean(idd_measured["IDD6"]))
    tot6 = t.tRP + t.tCKE + idle8 + t.tXS
    i_sr = max((idd6_mean * tot6 - i2n * (t.tRP + t.tCKE))
               / (idle8 + t.tXS), 0.1)

    vc = VendorCharacterization(
        act_surface=act_surface,
        vendor=vendor, idd_measured=idd_measured,
        idd_datasheet=ds_vals[vendor], idd_extrapolation_r2=ds_r2[vendor],
        datadep=datadep, datadep_r2=datadep_r2, ones_sweep=ones_sweep_raw,
        i2n=i2n, bank_open_delta=bank_open_delta,
        bank_read_factor=bank_read_factor,
        bank_write_factor=bank_write_factor, q_actpre=q_actpre,
        row_ones_slope=row_ones_slope,
        row_sweep={"row_ones": row_ones, "current": row_cur, "r2": rf.r2},
        q_ref=q_ref, i_pd=i_pd,
        i_pd_slow=i_pd_slow, i_actpd=i_actpd, i_sr=i_sr)
    vc.build_params()
    return vc


def characterize_fleet(modules=None, **kw) -> dict[int, VendorCharacterization]:
    modules = device_sim.make_fleet() if modules is None else modules
    out = {}
    for v in range(3):
        mods = device_sim.vendor_modules(modules, v)
        if mods:
            out[v] = characterize_vendor(mods, v, **kw)
    return out
