"""The port's online recalibration (``repro_torch.core.recalibrate``, the
``'streaming'`` fitter and the service's telemetry hook) against the
reference's, on the 3 x 3 tiny fleet at the quick plan.

The tests of ``tests/test_recalibrate.py`` are mirrored on the port; on
top of them: the telemetry currents against the reference's at rtol 1e-5;
the fitter fed the reference's own telemetry (the stats, the detector's
scores and the refit against the reference's fitter: stats at rtol 1e-5,
the refit at the fit bar, rtol 1e-4 / atol 1e-6); and the refreshed
model's ``params(v)`` and saved file, which give the refreshed
parameters (the reference's rebuild keeps the stale ones: ROADMAP R7).

The reference's model comes across through its schema-v2 file; every draw
through the reference runs under ``jax.threefry_partitionable(True)``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import device_sim as rsim
from repro.core import model_api as rma
from repro.core import recalibrate as rrecal
from repro_torch.core import characterize as pchar
from repro_torch.core import device_sim as psim
from repro_torch.core import fitting as pfitting
from repro_torch.core import fleet as pfleet
from repro_torch.core import model_api as pma
from repro_torch.core import params as pparams
from repro_torch.core import recalibrate as precal
from repro_torch.core import validate as pval
from repro_torch.core.device_sim import NO_DRIFT, DriftProcess

RTOL = 1e-5
FIT_BAR = dict(rtol=1e-4, atol=1e-6)
SPECS = [pparams.ModuleSpec(v, i, 2015) for v in range(3) for i in range(3)]
TRACKING_DRIFT = dict(temp_amp=0.01, temp_period=64.0, aging_rate=8e-3,
                      act_aging_rate=5e-3, noise_sigma=1e-3)


@pytest.fixture(autouse=True)
def partitionable():
    # pin JAX's partitionable Threefry stream (the port's) for this test
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several workers on the machine's cores; these many
    small tensor operations run faster on one thread each than on
    threads that contend with the other workers' (results are compared
    at the stated tolerances either way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(quick_vampire, tmp_path_factory):
    """The reference's quick fit, carried across by its schema-v2 file."""
    path = tmp_path_factory.mktemp("recal") / "quick.npz"
    rma.save_estimator(quick_vampire, str(path))
    return pma.load_estimator(str(path), device="cpu")


@pytest.fixture(scope="module")
def fleet():
    return psim.make_fleet(SPECS)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Drift process (the port's device_sim)
# ---------------------------------------------------------------------------
def test_drift_factors_seed_stable():
    v = [s.vendor for s in SPECS]
    m = [s.module_id for s in SPECS]
    bg1, act1 = psim.drift_factors(v, m, 17)
    bg2, act2 = psim.drift_factors(v, m, 17)
    np.testing.assert_array_equal(bg1, bg2)
    np.testing.assert_array_equal(act1, act2)
    bg_sub, act_sub = psim.drift_factors(v[3:5], m[3:5], 17)
    np.testing.assert_array_equal(bg_sub, bg1[3:5])
    np.testing.assert_array_equal(act_sub, act1[3:5])
    bg3, _ = psim.drift_factors(v, m, 18)
    assert not np.array_equal(bg1, bg3)


def test_drift_no_drift_is_identity():
    v = [s.vendor for s in SPECS]
    m = [s.module_id for s in SPECS]
    bg, act = psim.drift_factors(v, m, 123, NO_DRIFT)
    np.testing.assert_allclose(bg, 1.0, rtol=1e-6)
    np.testing.assert_allclose(act, 1.0, rtol=1e-6)


def test_drift_aging_monotone_and_step():
    drift = DriftProcess(temp_amp=0.0, aging_rate=2e-3, act_aging_rate=1e-3,
                         noise_sigma=0.0)
    bgs = [psim.drift_factors([0], [0], t, drift)[0][0]
           for t in (0, 10, 50, 200)]
    assert all(b2 > b1 for b1, b2 in zip(bgs, bgs[1:]))
    step = dataclasses.replace(NO_DRIFT, step_tick=8, step_frac=0.2)
    before, _ = psim.drift_factors([0], [0], 7, step)
    after, after_act = psim.drift_factors([0], [0], 8, step)
    np.testing.assert_allclose(before, 1.0, rtol=1e-6)
    np.testing.assert_allclose(after, 1.2, rtol=1e-6)
    np.testing.assert_allclose(after_act, 1.2, rtol=1e-6)


def test_apply_drift_scales_expected_fields(fleet):
    stacked = pfleet.stack_params([m.params for m in fleet[:2]])
    drift = DriftProcess(temp_amp=0.0, aging_rate=5e-3, act_aging_rate=0.0,
                         noise_sigma=0.0)
    drifted = psim.apply_drift(stacked, [s.vendor for s in SPECS[:2]],
                               [s.module_id for s in SPECS[:2]], 100, drift)
    np.testing.assert_allclose(_np(drifted.i2n), _np(stacked.i2n) * 1.5,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(drifted.q_actpre), _np(stacked.q_actpre),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# Decayed sufficient statistics
# ---------------------------------------------------------------------------
def test_update_stats_matches_numpy_reference(rng):
    """One float32 step, the observed cells written in place; nothing is
    promoted to float64."""
    M, C, width = 3, 10, 4
    stats = precal.RunningStats(torch.zeros(M, C), torch.zeros(M, C))
    w_ref = np.zeros((M, C), np.float32)
    m_ref = np.zeros((M, C), np.float32)
    decay = np.float32(0.8)
    pred = torch.zeros(M, C)
    for k in range(6):
        idx = np.asarray([(k * width + j) % C for j in range(width)])
        obs = rng.normal(10.0, 1.0, size=(M, width)).astype(np.float32)
        weight = stats.weight
        stats, z = precal._update_stats(
            stats, torch.from_numpy(obs), torch.from_numpy(idx),
            torch.tensor(decay), pred, torch.tensor(np.float32(0.01)))
        assert stats.weight is weight                 # in place
        assert stats.mean.dtype == z.dtype == torch.float32
        old = decay * w_ref[:, idx]
        w_ref[:, idx] = old + 1.0
        m_ref[:, idx] = (old * m_ref[:, idx] + obs) / w_ref[:, idx]
    np.testing.assert_allclose(_np(stats.weight), w_ref, rtol=1e-6)
    np.testing.assert_allclose(_np(stats.mean), m_ref, rtol=1e-5)


def test_update_stats_matches_the_reference(rng):
    M, C = 4, 12
    w = rng.uniform(0.5, 3.0, (M, C)).astype(np.float32)
    m = rng.uniform(50, 400, (M, C)).astype(np.float32)
    pred = rng.uniform(50, 400, (M, C)).astype(np.float32)
    idx = np.asarray([2, 5, 6, 11])
    obs = (pred[:, idx] * rng.normal(1.0, 0.03, (M, 4))).astype(np.float32)
    r_stats, r_z = rrecal._update_stats(
        rrecal.RunningStats(w, m), obs, idx, np.float32(0.7), pred,
        np.float32(0.01))
    p_stats, p_z = precal._update_stats(
        precal.RunningStats(torch.from_numpy(w.copy()),
                            torch.from_numpy(m.copy())),
        torch.from_numpy(obs), torch.from_numpy(idx),
        torch.tensor(np.float32(0.7)), torch.from_numpy(pred),
        torch.tensor(np.float32(0.01)))
    for a, b in zip(r_stats, p_stats):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=RTOL)
    np.testing.assert_allclose(_np(p_z), np.asarray(r_z), rtol=RTOL,
                               atol=1e-5)


def test_decay_one_is_exact_running_mean(rng):
    w = torch.tensor(0.0)
    m = torch.tensor(0.0)
    xs = rng.normal(5.0, 2.0, size=12).astype(np.float32)
    for i, x in enumerate(xs):
        w, m = pfitting.decayed_moment_update(w, m, torch.tensor(x), 1.0)
        np.testing.assert_allclose(float(m), np.mean(xs[:i + 1]), rtol=1e-5)
        assert float(w) == pytest.approx(i + 1)


def test_streaming_refit_equals_from_scratch_refit(model, fleet):
    """With decay=1 and no seed mass, the streaming refit over the fed
    telemetry equals ``invert_campaign`` run from scratch on the plain
    per-cell means of the same stream."""
    cfg = precal.RecalConfig(decay=1.0, seed_weight=0.0, slice_size=10_000)
    fitter = precal.StreamingFitter(model, SPECS, cfg)
    src = precal.TelemetrySource(fleet, cfg, drift=NO_DRIFT, noisy=False,
                                 device="cpu")
    for tick in range(2):
        cur, idx = src.measure(tick)
        fitter.observe(cur, idx, tick)
    streamed = fitter.refit()

    mean = _np(fitter.stats.mean).astype(np.float64)
    plan = fitter.plan
    fitted = []
    for v in model.vendors:
        rows = [i for i, s in enumerate(SPECS) if s.vendor == v]
        idd = {key: mean[rows, i] for i, key in enumerate(pchar.IDD_KEYS)}
        pm = mean[rows[:cfg.probe_modules],
                  len(pchar.IDD_KEYS):].mean(axis=0)
        cur = {pt.label: float(pm[i])
               for i, pt in enumerate(plan.probe_points)}
        fitted.append(pchar.invert_campaign(plan, v, idd_measured=idd,
                                            cur=cur).fitted)
    scratch = pfleet.stack_params(fitted)
    for name, got, want in zip(scratch._fields, streamed.fleet.params,
                               scratch):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# Fitter registry
# ---------------------------------------------------------------------------
def test_fitter_registry_resolution():
    assert set(pma.registered_fitters()) >= {"campaign", "streaming"}
    assert pma.resolve_fitter("campaign").streaming is False
    assert pma.resolve_fitter("offline").name == "campaign"
    assert pma.resolve_fitter("online").name == "streaming"
    assert pma.resolve_fitter("streaming", streaming=True).streaming
    with pytest.raises(ValueError, match="registered fitters"):
        pma.resolve_fitter("nope")
    with pytest.raises(ValueError, match="one-shot"):
        pma.resolve_fitter("campaign", streaming=True)
    with pytest.raises(ValueError, match="streaming"):
        pma.resolve_fitter("streaming", streaming=False)


def test_fit_streaming_requires_vampire(fleet):
    with pytest.raises(ValueError, match="VAMPIRE"):
        pma.fit("micron", fleet, fitter="streaming", device="cpu")


@pytest.mark.parametrize("name", ["streaming", "online"])
def test_fit_streaming_returns_a_primed_fitter(model, fleet, name):
    cfg = precal.RecalConfig()
    fitter = pma.fit("vampire", fleet, fitter=name, init_model=model,
                     config=cfg, device="cpu")
    assert isinstance(fitter, precal.StreamingFitter)
    assert fitter.model is not model and fitter.device.type == "cpu"
    assert tuple(fitter.stats.mean.shape) == (len(SPECS), 360)
    # primed on the model's own predictions: no drift seen yet
    cur = _np(fitter.stats.mean)[:, :cfg.slice_size]
    assert fitter.observe(cur, np.arange(cfg.slice_size), 0).score < 1e-3


# ---------------------------------------------------------------------------
# Drift detector
# ---------------------------------------------------------------------------
def test_detector_fires_on_planted_step(model, fleet):
    cfg = precal.RecalConfig()
    step = dataclasses.replace(NO_DRIFT, step_tick=4, step_frac=0.15)
    fitter = precal.StreamingFitter(model, SPECS, cfg)
    src = precal.TelemetrySource(fleet, cfg, drift=step, device="cpu")
    reports = []
    for tick in range(1, 7):
        cur, idx = src.measure(tick)
        reports.append(fitter.observe(cur, idx, tick))
    assert not any(r.triggered for r in reports[:3])   # before the step
    assert all(r.triggered for r in reports[3:])       # from the step on
    assert reports[3].score > 2 * cfg.drift_threshold
    assert set(reports[3].by_key)


def test_detector_quiet_without_drift(model, fleet):
    cfg = precal.RecalConfig()
    fitter = precal.StreamingFitter(model, SPECS, cfg)
    src = precal.TelemetrySource(fleet, cfg, drift=NO_DRIFT, device="cpu")
    scores = []
    for tick in range(1, 13):
        cur, idx = src.measure(tick)
        scores.append(fitter.observe(cur, idx, tick).score)
    assert max(scores) < cfg.drift_threshold


# ---------------------------------------------------------------------------
# The tracking gate: frozen diverges, recalibrated tracks
# ---------------------------------------------------------------------------
def test_frozen_diverges_recalibrated_tracks(model, fleet):
    cfg = precal.RecalConfig(decay=0.7, slice_size=120)
    drift = DriftProcess(**TRACKING_DRIFT)
    fitter = precal.StreamingFitter(model, SPECS, cfg)
    frozen = fitter.model
    src = precal.TelemetrySource(fleet, cfg, drift=drift, device="cpu")
    tb = src.batch
    ckpts = (30, 60, 90, 120)
    frozen_err, recal_err = [], []
    for tick in range(1, ckpts[-1] + 1):
        cur, idx = src.measure(tick)
        if fitter.observe(cur, idx, tick).triggered:
            fitter.refit()
        if tick in ckpts:
            truth = src.true_params_at(tick)
            frozen_err.append(precal.fleet_current_mape(
                frozen, tb.trace, tb.weight, SPECS, truth))
            recal_err.append(precal.fleet_current_mape(
                fitter.model, tb.trace, tb.weight, SPECS, truth))
    assert all(b > a for a, b in zip(frozen_err, frozen_err[1:]))
    assert frozen_err[-1] >= 5.0 * recal_err[-1]
    truth = src.true_params_at(ckpts[-1])
    drifted = [psim.SimulatedModule(s, truth.select(i))
               for i, s in enumerate(SPECS)]
    oracle = pma.fit("vampire", drifted, fitter="campaign", device="cpu",
                     probe_modules=2, probe_reps=64, n_rows=8)
    oracle_err = precal.fleet_current_mape(oracle, tb.trace, tb.weight,
                                           SPECS, truth)
    assert recal_err[-1] <= 2.0 * oracle_err


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["vectorized", "cuda"])
def test_telemetry_matches_the_reference(tiny_fleet, fleet, impl):
    """The drifted, noisy telemetry slices at rtol 1e-5 (``'cuda'`` runs
    the kernels' plain versions on the CPU), and the ground truth."""
    cfg = precal.RecalConfig(slice_size=100)
    rdrift = rsim.DriftProcess(**TRACKING_DRIFT)
    ref = rrecal.TelemetrySource(tiny_fleet, rrecal.RecalConfig(
        slice_size=100), drift=rdrift)
    port = precal.TelemetrySource(fleet, cfg, drift=DriftProcess(
        **TRACKING_DRIFT), impl=impl, device="cpu")
    assert port.n_cells == ref.n_cells == 360
    for tick in (1, 3, 60):
        rcur, ridx = ref.measure(tick)
        pcur, pidx = port.measure(tick)
        np.testing.assert_array_equal(pidx, ridx)
        np.testing.assert_allclose(pcur, rcur, rtol=RTOL,
                                   err_msg=f"tick {tick}")
    rtrue, ptrue = ref.true_params_at(60), port.true_params_at(60)
    for name, a, b in zip(rtrue._fields, rtrue, ptrue):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=RTOL,
                                   err_msg=name)


def test_fitter_fed_the_reference_telemetry(quick_vampire, tiny_fleet,
                                            model):
    """Both fitters fed the reference's telemetry: the stats and the
    detector's scores at rtol 1e-5, ``triggered`` where the score is clear
    of the threshold, and the refit at the fit bar."""
    rcfg = rrecal.RecalConfig(decay=0.7, slice_size=120)
    pcfg = precal.RecalConfig(decay=0.7, slice_size=120)
    step = dataclasses.replace(rsim.NO_DRIFT, step_tick=3, step_frac=0.1)
    src = rrecal.TelemetrySource(tiny_fleet, rcfg, drift=step)
    ref = rrecal.StreamingFitter(quick_vampire, SPECS, rcfg)
    port = precal.StreamingFitter(model, SPECS, pcfg)
    np.testing.assert_allclose(_np(port.stats.mean),
                               np.asarray(ref.stats.mean), rtol=RTOL)
    triggered = 0
    for tick in range(1, 6):
        cur, idx = src.measure(tick)
        r, p = ref.observe(cur, idx, tick), port.observe(cur, idx, tick)
        assert list(p.by_key) == list(r.by_key)
        np.testing.assert_allclose(list(p.by_key.values()),
                                   list(r.by_key.values()), rtol=RTOL,
                                   atol=1e-4)
        np.testing.assert_allclose(p.score, r.score, rtol=RTOL, atol=1e-4)
        if abs(r.score - rcfg.drift_threshold) > 1e-3:
            assert p.triggered == r.triggered
            triggered += r.triggered
    assert triggered >= 2
    for a, b in zip(ref.stats, port.stats):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=RTOL)
    r_model, p_model = ref.refit(), port.refit()
    for name, a, b in zip(r_model.fleet.params._fields,
                          r_model.fleet.params, p_model.fleet.params):
        np.testing.assert_allclose(_np(b), np.asarray(a), err_msg=name,
                                   **FIT_BAR)
    np.testing.assert_allclose(_np(port._predicted),
                               np.asarray(ref._predicted), rtol=1e-4)


def test_fleet_current_mape_matches_the_reference(quick_vampire, tiny_fleet,
                                                  model, fleet):
    cfg = precal.RecalConfig()
    drift = DriftProcess(**TRACKING_DRIFT)
    ref = rrecal.TelemetrySource(tiny_fleet, rrecal.RecalConfig(),
                                 drift=rsim.DriftProcess(**TRACKING_DRIFT))
    port = precal.TelemetrySource(fleet, cfg, drift=drift, device="cpu")
    tb, rb = port.batch, ref.batch
    for tick in (0, 50):
        want = rrecal.fleet_current_mape(quick_vampire, rb.trace, rb.weight,
                                         SPECS, ref.true_params_at(tick))
        for impl in ("vectorized", "cuda"):
            got = precal.fleet_current_mape(model, tb.trace, tb.weight,
                                            SPECS, port.true_params_at(tick),
                                            impl=impl)
            np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# The refreshed model (ROADMAP R7: the port's params(v) and save are the
# refit's; the reference's rebuild keeps the stale ones)
# ---------------------------------------------------------------------------
def test_refreshed_model_params_and_save(model, fleet, tmp_path):
    cfg = precal.RecalConfig(slice_size=10_000)
    step = dataclasses.replace(NO_DRIFT, step_tick=1, step_frac=0.2)
    fitter = precal.StreamingFitter(model, SPECS, cfg)
    src = precal.TelemetrySource(fleet, cfg, drift=step, device="cpu")
    cur, idx = src.measure(1)
    assert fitter.observe(cur, idx, 1).triggered
    new = fitter.refit()
    assert new is fitter.model and new is not model
    assert new.vendors == model.vendors and new.idd_keys == model.idd_keys
    for a, b in ((new.fleet.band, model.fleet.band),
                 (new.fleet.idd_datasheet, model.fleet.idd_datasheet),
                 (new.fleet.vendor_ids, model.fleet.vendor_ids)):
        assert a is b
    for name, a, b in zip(model.fleet.params._fields, model.fleet.params,
                          new.fleet.params):
        assert (a.shape, a.dtype, a.device) == (b.shape, b.dtype, b.device)
    assert not torch.equal(new.fleet.params.i2n, model.fleet.params.i2n)
    for i, v in enumerate(new.vendors):
        for name, a, b in zip(new.fleet.params._fields,
                              new.fleet.params.select(i), new.params(v)):
            assert torch.equal(a, b), name
    # the refit's own campaign arrays, not the old fit's
    assert new.saved is not model.saved
    assert not np.array_equal(new.saved.arrays["i2n"],
                              model.saved.arrays["i2n"])
    np.testing.assert_array_equal(new.saved.arrays["band"],
                                  model.saved.arrays["band"])
    path = tmp_path / "refit.npz"
    new.save(str(path))
    loaded = pma.load_estimator(str(path), device="cpu")
    for v in new.vendors:
        for name, a, b in zip(new.params(v)._fields, new.params(v),
                              loaded.params(v)):
            assert torch.equal(a, b), (v, name)
    assert torch.equal(loaded.fleet.band, model.fleet.band)
    ratios = pval.measured_over_datasheet(loaded)
    assert ratios[0]["IDD2N"] > pval.measured_over_datasheet(
        model)[0]["IDD2N"]     # the 20 % step shows in the measured IDDs


# ---------------------------------------------------------------------------
# Fit-while-serving
# ---------------------------------------------------------------------------
def test_fit_while_serving_zero_recompiles(model, fleet):
    from repro_torch.core import idd_loops
    from repro_torch.kernels import build
    from repro_torch.serving import EstimationService, ServiceConfig

    cfg = precal.RecalConfig(slice_size=10_000)
    step = dataclasses.replace(NO_DRIFT, step_tick=1, step_frac=0.2)
    fitter = precal.StreamingFitter(model, SPECS, cfg)
    svc = EstimationService(model, ServiceConfig(lint=False), fitter=fitter)
    src = precal.TelemetrySource(fleet, cfg, drift=step, device="cpu")
    trs = [idd_loops.idd0(reps=2), idd_loops.idd4r(reps=2)]

    tickets, _ = svc.submit_many(trs)
    svc.drain()
    before = svc.engine.cache_size()
    buckets = set(svc.ring._buffers)
    libs = dict(build._LIBS)
    res_before = _np(svc.result(tickets[0]).energy_pj)

    cur, idx = src.measure(1)
    report = svc.observe_telemetry(cur, idx, tick=1)
    assert report.triggered

    tickets2, _ = svc.submit_many(trs)
    svc.drain()
    res_after = _np(svc.result(tickets2[0]).energy_pj)
    m = svc.metrics()
    assert m.recalibrations == 1
    assert m.drift_score == pytest.approx(report.score)
    assert m.drift_peak >= m.drift_score
    assert m.drift_by_key == report.by_key
    assert svc.engine.cache_size() == before == m.engine_programs
    assert set(svc.ring._buffers) == buckets
    assert dict(build._LIBS) == libs
    assert not np.array_equal(res_before, res_after)
    want = fitter.model.estimate(trs[:1]).energy_pj
    np.testing.assert_allclose(res_after, _np(want)[0], rtol=RTOL)


def test_service_without_fitter_raises(model):
    from repro_torch.serving import EstimationService, ServiceConfig
    svc = EstimationService(model, ServiceConfig(lint=False))
    with pytest.raises(RuntimeError, match="streaming fitter"):
        svc.observe_telemetry(np.zeros((1, 1)), [0], tick=0)


def test_entry_points_default_to_the_card(fleet):
    """Without ``device=`` the telemetry source and the streaming fitter
    run on ``cuda``, and raise rather than fall back where there is no
    card."""
    if torch.cuda.is_available():
        assert precal.TelemetrySource(fleet).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        precal.TelemetrySource(fleet)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pma.fit("vampire", fleet, fitter="streaming")


def test_cell_set_refuses_the_oracle_impl():
    with pytest.raises(ValueError, match="'vectorized' or 'cuda'"):
        precal.CellSet(precal.RecalConfig(), "reference", "cpu")
    assert precal.cell_group(("idd", "IDD0")) == "idd/IDD0"
    assert precal.cell_group(("surface", 1, 2)) == "surface"
