"""The port's characterization campaign against the reference's, at the
reference's quick sizes (the 3 x 3 tiny fleet, ``probe_modules=2``,
``probe_reps=64``, ``n_rows=8``): the plan and its noise keys, the
datasheets, ``invert_campaign`` (bit for bit on the reference's currents
given the reference's least-squares primitive; the port's own float32
least squares at the fit bar), the whole fit at rtol 1e-4 / atol 1e-6,
the serial oracle and the kernels' plain versions against the batched
engine, the committed quick fit, the saved file, and the fitter registry.

The reference fit and measurements run under
``jax.threefry_partitionable(True)``: the port follows JAX's partitionable
Threefry stream, the default from JAX 0.5 but not under JAX 0.4.x, so it
is pinned for their duration."""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import characterize as rchar
from repro.core import fitting as rfitting
from repro.core import fleet as rfleet
from repro.core import model_api as rma
from repro.core import params as rparams
from repro.core import device_sim as rsim
from repro.core.vampire import Vampire as RVampire
from repro_torch.core import characterize as pchar
from repro_torch.core import device_sim as psim
from repro_torch.core import fitting as pfitting
from repro_torch.core import model_api as pma
from repro_torch.core import params as pparams
from repro_torch.core.vampire import Vampire as PVampire

QUICK = dict(probe_modules=2, probe_reps=64, n_rows=8)
SPECS = [(v, i, 2015) for v in range(3) for i in range(3)]
FIT_BAR = dict(rtol=1e-4, atol=1e-6)   # test_fleet_engine.py's bar
MODEL = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "data" / "vampire_quickfit_v2.npz")
# the VendorCharacterization fields that do not go through a least-squares
# fit or the datasheet derivation: float64 arithmetic on the currents
EXACT_FIELDS = ("i2n", "bank_open_delta", "bank_read_factor",
                "bank_write_factor", "act_surface", "q_ref", "i_pd",
                "i_pd_slow", "i_sr")
LSTSQ_FIELDS = ("datadep", "q_actpre", "row_ones_slope", "i_actpd")


def _port_fleet():
    return psim.make_fleet([pparams.ModuleSpec(*s) for s in SPECS])


@pytest.fixture(scope="module")
def fits():
    """(reference, port) quick fits of the tiny fleet."""
    with jax.threefry_partitionable(True):
        ref = RVampire.fit(rsim.make_fleet(
            [rparams.ModuleSpec(*s) for s in SPECS]), **QUICK)
    port = pma.fit("vampire", _port_fleet(), fitter="campaign",
                   device="cpu", **QUICK)
    return ref, port


def _assert_fit(ref_params, port_params, what):
    for name, a, b in zip(ref_params._fields, ref_params, port_params):
        np.testing.assert_allclose(b.cpu().numpy(), np.asarray(a),
                                   err_msg=f"{what} {name}", **FIT_BAR)


def _assert_models(want: PVampire, got: PVampire, what: str):
    assert got.vendors == want.vendors
    for i, v in enumerate(want.vendors):
        _assert_fit(want.params(v), got.params(v), f"{what} vendor {v}")
    np.testing.assert_allclose(got.fleet.band.numpy(),
                               want.fleet.band.numpy(), rtol=1e-6)


def test_whole_fit_matches_the_reference(fits):
    ref, port = fits
    assert isinstance(port, PVampire) and port.vendors == ref.vendors
    assert port.device == torch.device("cpu")
    for v in ref.vendors:
        _assert_fit(ref.params(v), port.params(v), f"vendor {v}")
        np.testing.assert_allclose(port.fleet.band[v].numpy(),
                                   ref.variation_band[v], rtol=1e-6)
        for k, x in port.datasheets()[v].items():
            np.testing.assert_allclose(
                x, ref.by_vendor[v].idd_datasheet[k], rtol=1e-5)
    assert port.idd_keys == tuple(sorted(ref.by_vendor[0].idd_datasheet))


def test_quick_fit_matches_the_committed_file(fits):
    """The check ``chip_smoke.py`` makes on the card, where there is no
    JAX: the fitted arrays of the committed quick fit at the fit bar."""
    _, port = fits
    with np.load(MODEL, allow_pickle=False) as z:
        assert sorted(z.files) == sorted([*port.saved.arrays,
                                          "__manifest__"])
        for name in port.saved.arrays:
            np.testing.assert_allclose(port.saved.arrays[name], z[name],
                                       err_msg=name, **FIT_BAR)


def _reference_measurements(vendor: int):
    """The reference's (plan, cur, idd_measured) of one vendor's quick
    campaign, as its ``characterize_vendor`` computes them."""
    mods = rsim.vendor_modules(
        rsim.make_fleet([rparams.ModuleSpec(*s) for s in SPECS]), vendor)
    plan = rchar.campaign_plan(probe_reps=64, n_rows=8)
    with jax.threefry_partitionable(True):
        idd = rfleet.run_probes(mods, plan.idd_points, batch=plan.idd_batch)
        probe = rfleet.run_probes(mods[:2], plan.probe_points,
                                  batch=plan.probe_batch)
    mean = probe.mean(axis=0)
    cur = {pt.label: float(mean[i]) for i, pt in enumerate(plan.probe_points)}
    idd_measured = {k: idd[:, i] for i, k in enumerate(rchar.IDD_KEYS)}
    return plan, cur, idd_measured


def _fields(vc):
    out = {f: getattr(vc, f) for f in EXACT_FIELDS + LSTSQ_FIELDS
           + ("datadep_r2", "idd_datasheet", "idd_extrapolation_r2")}
    out["row_sweep"] = vc.row_sweep
    out.update({f"sweep/{k}/{f}": v[f] for k, v in vc.ones_sweep.items()
                for f in v})
    return out


def _equal(a, b, what):
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=what)


@pytest.mark.parametrize("vendor", [0, 2])
def test_invert_campaign_is_bit_for_bit_on_the_reference_inputs(
        vendor, monkeypatch):
    """Given the reference's currents, the reference's float32
    least-squares primitive (LAPACK ``sgesdd`` through JAX; the port's is
    numpy's) and its datasheets, every fitted quantity is the reference's
    bit for bit; with the port's own primitive the quantities that do not
    go through a fit stay bit for bit and the others meet the fit bar."""
    plan, cur, idd = _reference_measurements(vendor)
    want = rchar.invert_campaign(plan, vendor, cur, idd)
    pplan = pchar.campaign_plan(probe_reps=64, n_rows=8)
    assert [p.label for p in pplan.probe_points] == list(cur)
    assert pplan.rows == plan.rows

    own = pchar.invert_campaign(pplan, vendor, cur, idd)
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(own, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in LSTSQ_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(own, f), np.float32),
                                   np.asarray(getattr(want, f), np.float32),
                                   err_msg=f, **FIT_BAR)

    monkeypatch.setattr(pfitting, "lstsq_fit", rfitting.lstsq_fit)
    monkeypatch.setattr(pchar, "extrapolated_datasheets",
                        rchar.extrapolated_datasheets)
    got = pchar.invert_campaign(pplan, vendor, cur, idd)
    _equal(_fields(want), _fields(got), f"vendor {vendor}")
    for name, a, b in zip(want.fitted._fields, want.fitted, got.fitted):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_campaign_plan_and_datasheets_match_the_reference():
    rplan = rchar.campaign_plan(probe_reps=64, n_rows=8)
    pplan = pchar.campaign_plan(probe_reps=64, n_rows=8)
    for rp, pp in ((rplan.idd_points, pplan.idd_points),
                   (rplan.probe_points, pplan.probe_points)):
        assert [(p.label, p.skip, p.key) for p in pp] == \
            [(p.label, p.skip, p.key) for p in rp]
    assert tuple(pplan.idd_batch.weight.shape) == (12, 1536)
    assert tuple(pplan.probe_batch.weight.shape) == (348, 262)
    for rb, pb in ((rplan.idd_batch, pplan.idd_batch),
                   (rplan.probe_batch, pplan.probe_batch)):
        for name, a, b in zip(rb.trace._fields, rb.trace, pb.trace):
            b = b.numpy().view(np.uint32) if name == "data" else b.numpy()
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)
        np.testing.assert_array_equal(pb.weight.numpy(),
                                      np.asarray(rb.weight))
        np.testing.assert_array_equal(pb.keys, rb.keys)
    assert pplan.batch_on("probe_batch", "cpu") is \
        pplan.batch_on("probe_batch", "cpu")
    for b in range(8):
        assert pchar.surface_probe_row(b) == rchar.surface_probe_row(b)

    rds, pds = rchar.derive_datasheets(), pchar.derive_datasheets()
    rtab, ptab = rchar.published_freq_tables(), pchar.published_freq_tables()
    (rvals, rr2), (pvals, pr2) = (rchar.extrapolated_datasheets(),
                                  pchar.extrapolated_datasheets())
    for v in range(3):
        assert list(pds[v]) == list(rds[v]) == list(rchar.IDD_KEYS)
        for k in rchar.IDD_KEYS:
            np.testing.assert_allclose(pds[v][k], rds[v][k], rtol=1e-6)
            np.testing.assert_array_equal(ptab[v][k], rtab[v][k])
            np.testing.assert_allclose(pvals[v][k], rvals[v][k], rtol=1e-5)
            np.testing.assert_allclose(pr2[v][k], rr2[v][k], rtol=1e-5)


def test_fitting_helpers_match_the_reference():
    rng = np.random.default_rng(11)
    for n in (3, 9, 36):
        ones = rng.integers(0, 513, n).astype(np.float64)
        tog = rng.integers(0, 257, n).astype(np.float64)
        cur = 250 + 0.4 * ones + 0.05 * tog + rng.normal(0, 0.5, n)
        want = rfitting.fit_ones_toggles(ones, tog, cur)
        got = pfitting.fit_ones_toggles(ones, tog, cur)
        assert got.coef.dtype == np.float32
        np.testing.assert_allclose(got.coef, want.coef, rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(got.r2, want.r2, rtol=1e-5)
        np.testing.assert_allclose(got.resid_rms, want.resid_rms, rtol=1e-3,
                                   atol=1e-4)
    for i in range(5):
        np.testing.assert_array_equal(
            pfitting.synth_datasheet_freq_table(10.0 + 40 * i, seed=i),
            rfitting.synth_datasheet_freq_table(10.0 + 40 * i, seed=i))
    w, m, x = np.float32(3.0), np.float32(2.5), np.float32(4.0)
    for decay in (1.0, 0.9):
        got = pfitting.decayed_moment_update(w, m, x, decay)
        want = rfitting.decayed_moment_update(w, m, x, decay)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        t = pfitting.decayed_moment_update(torch.tensor(3.0),
                                           torch.tensor(2.5),
                                           torch.tensor(4.0), decay)
        np.testing.assert_allclose([float(y) for y in t], got, rtol=1e-7)


def test_serial_oracle_fits_the_batched_engine(fits):
    """``test_fleet_engine.py``'s acceptance bar, in the port: the
    measurement-at-a-time oracle fits the batched engine's params."""
    _, port = fits
    mods = psim.vendor_modules(_port_fleet(), 1)
    serial = pchar.characterize_vendor(mods, 1, engine="serial",
                                       device="cpu", **QUICK)
    _assert_fit(port.params(1), serial.fitted, "serial vendor 1")


def test_kernel_impl_fits_the_vectorized_engine(fits):
    """``impl='cuda'`` (on CPU tensors, the kernels' plain versions)
    fits the ``'vectorized'`` engine's params."""
    _, port = fits
    cuda = pma.fit("vampire", _port_fleet(), impl="cuda", device="cpu",
                   **QUICK)
    _assert_models(port, cuda, "cuda")


def test_saved_file_has_the_reference_entries(fits, tmp_path):
    ref, port = fits
    rpath, ppath = tmp_path / "ref.npz", tmp_path / "port.npz"
    ref.save(str(rpath))
    port.save(str(ppath))
    with np.load(rpath, allow_pickle=False) as rz, \
            np.load(ppath, allow_pickle=False) as pz:
        assert sorted(pz.files) == sorted(rz.files)
        rman = json.loads(rz["__manifest__"].item())
        pman = json.loads(pz["__manifest__"].item())
        assert pman["raw"] is True and rman["raw"] is True
        for key in ("schema", "kind", "vendors", "idd_keys"):
            assert pman[key] == rman[key], key
        assert pman["row_r2"].keys() == rman["row_r2"].keys()
        np.testing.assert_allclose(list(pman["row_r2"].values()),
                                   list(rman["row_r2"].values()), rtol=1e-4)
        for v, r2s in rman["idd_r2"].items():
            assert list(pman["idd_r2"][v]) == list(r2s)
            np.testing.assert_allclose(list(pman["idd_r2"][v].values()),
                                       list(r2s.values()), rtol=1e-4)
        for name in rz.files:
            if name == "__manifest__":
                continue
            assert pz[name].dtype == rz[name].dtype, name
            np.testing.assert_allclose(pz[name], rz[name], err_msg=name,
                                       **FIT_BAR)
    # the port reads its file back to the same estimates; the reference
    # reads it too
    from repro_torch.core import idd_loops
    loaded = PVampire.load(str(ppath), device="cpu")
    trs = [idd_loops.validation_sweep(12), idd_loops.idd4w(reps=4)]
    for mode in ("mean", "surface"):
        a = port.estimate(trs, mode=mode)
        b = loaded.estimate(trs, mode=mode)
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), (mode, name)
    assert rma.load_estimator(str(ppath)).vendors == ref.vendors


def test_fitter_registry_and_refusals(fits):
    _, port = fits
    assert pma.registered_fitters() == ("campaign", "streaming")
    assert pma.resolve_fitter("offline") is pma.CAMPAIGN_FITTER
    assert pma.resolve_fitter("online") is pma.STREAMING_FITTER
    with pytest.raises(ValueError, match="unknown fitter 'nowhere'"):
        pma.fit("vampire", _port_fleet(), fitter="nowhere", device="cpu")
    with pytest.raises(ValueError, match="one-shot, not streaming"):
        pma.resolve_fitter("campaign", streaming=True)
    spec = pma.register_fitter(pma.FitterSpec("nowhere", "no branch",
                                              streaming=False))
    try:
        with pytest.raises(ValueError, match="no dispatch branch"):
            pma.fit("vampire", _port_fleet(), fitter="nowhere",
                    device="cpu")
    finally:
        pma._FITTERS.pop(spec.name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pma.fit("vampire", _port_fleet(), **QUICK)
    drampower = pma.make_estimator("drampower", port)
    assert drampower.kind == "drampower" and drampower.vendors == (0, 1, 2)
