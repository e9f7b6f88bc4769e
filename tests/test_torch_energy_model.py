"""The port's vectorized integrator and command-by-command oracle against
the reference's: structural state (integers exact), per-command charges
(rtol 1e-5) under the true simulator params (with the ``ones_quad``
curvature) and the fitted ones, the surface grouping, and the dwell
billing of every background state."""
import jax
import numpy as np
import pytest
import torch

from repro.core import device_sim
from repro.core import dram as rdram
from repro.core import energy_model as rem
from repro.core import traces as rtraces
from repro_torch import convert
from repro_torch.core import dram as pdram
from repro_torch.core import energy_model as pem
from repro_torch.core import idd_loops

_T = rdram.TIMING
RTOL = 1e-5

# the reference's per-trace passes, compiled once per trace length
_ref_state = jax.jit(rem.structural_state)
_ref_features = jax.jit(rem.extract_structural_features)
_ref_charges = jax.jit(lambda tr, pp: rem.charge_from_features(
    tr, rem.extract_features(tr, pp), pp))


def _bridge(tr):
    return pdram.make_trace(*[np.asarray(f) for f in tr])


def _to_ref(tr):
    """A port trace (the port's generators) as the reference's."""
    return rdram.make_trace(*[f.numpy() for f in tr[:4]],
                            tr.data.numpy().view(np.uint32), tr.dt.numpy())


def _port_params(pp):
    return convert.power_params_from_numpy(
        {name: np.asarray(x) for name, x in zip(pp._fields, pp)})


def _lp_trace(d_fast=1, d_slow=1, d_act=1, d_sr=1):
    """One NOP dwell window in each low-power state."""
    P = rdram
    cmds = [P.PREA, P.PDE, P.NOP, P.PDX, P.PDE_SLOW, P.NOP, P.PDX,
            P.ACT, P.PDE, P.NOP, P.PDX, P.PREA, P.SRE, P.NOP, P.SRX]
    rows = [0] * 7 + [5] + [0] * 7
    dts = [_T.tRP, _T.tCKE, d_fast, _T.tXP, _T.tCKE, d_slow, _T.tXPDLL,
           _T.tRCD, _T.tCKE, d_act, _T.tXP, _T.tRP, _T.tCKE, d_sr, _T.tXS]
    return rdram.make_trace(cmds, [0] * 15, rows, [0] * 15, None, dts)


@pytest.fixture(scope="module")
def traces():
    rng = np.random.default_rng(17)
    data = rng.integers(0, 1 << 32, size=(40, 16), dtype=np.uint64)
    P = rdram
    # random bank/column interleaving over RD/WR with ACTs in between
    cmds = rng.choice([P.RD, P.WR, P.ACT, P.PRE, P.NOP, P.REF], size=40,
                      p=[0.4, 0.3, 0.1, 0.1, 0.05, 0.05])
    rand = rdram.make_trace(cmds, rng.integers(0, 8, 40),
                            rng.integers(0, 1 << 15, 40),
                            rng.integers(0, 4, 40), data.astype(np.uint32),
                            rng.integers(0, 9, 40))
    return [rtraces.app_trace(rtraces.SPEC_APPS[2], n_requests=80),
            rtraces.app_trace(rtraces.SPEC_APPS[9], n_requests=60),
            _to_ref(idd_loops.validation_sweep(12)),
            _to_ref(idd_loops.idd2p1()), _to_ref(idd_loops.idd6()),
            _lp_trace(7, 9, 11, 13), rand]


@pytest.fixture(scope="module")
def param_sets():
    """(reference, port) PowerParams: a true simulator module (with the
    ones_quad curvature) and a fitted vendor of the committed model."""
    from repro.core import model_api
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "src"
            / "repro_torch" / "data" / "vampire_quickfit_v2.npz")
    fitted = model_api.load_estimator(str(path)).params(1)
    true = device_sim.true_vendor_params(0)
    return [(pp, _port_params(pp)) for pp in (true, fitted)]


def test_structural_state_matches_reference(traces):
    for tr in traces:
        ref = _ref_state(tr)
        got = pem.structural_state(_bridge(tr))
        for name in ("is_rw", "op", "il_mode", "open_before", "bg_state",
                     "row_ones", "has_prev"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)
        prev = pem.prev_lines(_bridge(tr).data, got).numpy().view(np.uint32)
        np.testing.assert_array_equal(prev, np.asarray(ref.prev_data))


def test_structural_state_batched_equals_per_trace(traces):
    """One call over a padded (T, N) batch == per-trace calls."""
    ported = [_bridge(t) for t in traces]
    length = max(t.n for t in ported)
    batch = pdram.stack_traces([pdram.pad_trace(t, length) for t in ported])
    st = pem.structural_state(batch)
    for i, tr in enumerate(ported):
        one = pem.structural_state(tr)
        for name, a, b in zip(st._fields, st, one):
            np.testing.assert_array_equal(a[i, :tr.n].numpy(), b.numpy(),
                                          err_msg=name)


def test_structural_features_match_reference(traces):
    for tr in traces:
        ref = _ref_features(tr)
        got = pem.extract_structural_features(_bridge(tr))
        for name, a, b in zip(got._fields, got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        dref = rem.distribution_features(ref, 0.3, 0.2)
        dgot = pem.distribution_features(got, 0.3, 0.2)
        np.testing.assert_allclose(dgot.ones.numpy(), np.asarray(dref.ones))
        np.testing.assert_allclose(dgot.toggles.numpy(),
                                   np.asarray(dref.toggles))


def test_per_command_charges_match_reference(traces, param_sets):
    for rpp, ppp in param_sets:
        for tr in traces:
            ref = _ref_charges(tr, rpp)
            ptr = _bridge(tr)
            got = pem.charge_from_features(
                ptr, pem.extract_features(ptr, ppp), ppp)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=RTOL)


def test_scan_oracle_matches_reference(traces, param_sets):
    for rpp, ppp in param_sets:
        for tr in traces:
            ref = rem.trace_charges_scan(tr, rpp)
            got = pem.trace_charges_scan(_bridge(tr), ppp)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=RTOL)
            rep_r = rem.trace_energy_scan(tr, rpp)
            rep_p = pem.trace_energy_scan(_bridge(tr), ppp)
            for name, a, b in zip(rep_p._fields, rep_p, rep_r):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=RTOL, err_msg=name)


def test_vectorized_report_matches_scan(traces, param_sets):
    for _, ppp in param_sets:
        for tr in traces:
            ptr = _bridge(tr)
            a = pem.trace_energy_vectorized(ptr, ppp)
            b = pem.trace_energy_scan(ptr, ppp)
            assert int(a.cycles) == int(b.cycles)
            np.testing.assert_allclose(float(a.energy_pj),
                                       float(b.energy_pj), rtol=RTOL)


def test_surface_grouping_matches_reference(traces, param_sets):
    rpp, ppp = param_sets[1]
    for tr in traces:
        w = np.ones(tr.n, np.float32)
        w[: tr.n // 3] = 0.0
        rc = _ref_charges(tr, rpp)
        ptr = _bridge(tr)
        pc = pem.charge_from_features(ptr, pem.extract_features(ptr, ppp),
                                      ppp)
        pw = torch.from_numpy(w)
        np.testing.assert_allclose(
            pem.surface_charge(ptr, pw, pc).numpy(),
            np.asarray(rem.surface_charge(tr, w, rc)), rtol=RTOL)
        np.testing.assert_array_equal(
            pem.surface_cycles(ptr, pw).numpy(),
            np.asarray(rem.surface_cycles(tr, w)))
        charge, cycles = pem.masked_totals(ptr, pw, pc)
        rcharge, rcycles = rem.masked_totals(tr, w, rc)
        assert int(cycles) == int(rcycles)
        np.testing.assert_allclose(float(charge), float(rcharge), rtol=RTOL)


def test_background_lut_and_report_helpers(param_sets):
    rpp, ppp = param_sets[0]
    states = np.arange(5, dtype=np.int32)
    i_up = np.float32(123.5)
    np.testing.assert_allclose(
        pem.background_current(ppp, torch.from_numpy(states),
                               torch.tensor(i_up)).numpy(),
        np.asarray(rem.background_current(rpp, states, i_up)), rtol=1e-7)
    charge = torch.tensor([10.0, 2.5e6], dtype=torch.float32)
    cycles = torch.tensor([0, 4096], dtype=torch.int32)
    got = pem.scale_report(pem._report(charge, cycles), 1.25)
    ref = rem.scale_report(rem._report(charge.numpy(), cycles.numpy()), 1.25)
    for name, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("dwells", [(1, 1, 1, 1), (64, 128, 96, 256),
                                    (400, 3, 250, 17)])
def test_dwell_charge_is_dwell_times_lut(dwells, param_sets):
    """Stretching a command-free dwell by k cycles adds exactly k x the
    state's LUT current, in the vectorized path and the oracle."""
    _, pp = param_sets[0]
    leaves = ("i_pd", "i_pd_slow", "i_actpd", "i_sr")
    expected = sum((d - 1) * float(getattr(pp, leaf))
                   for d, leaf in zip(dwells, leaves))
    base, tr = _bridge(_lp_trace()), _bridge(_lp_trace(*dwells))
    for fn in (pem.trace_energy_vectorized, pem.trace_energy_scan):
        got = float(fn(tr, pp).charge_ma_cycles) - float(
            fn(base, pp).charge_ma_cycles)
        np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-2)


def test_power_params_stack_and_select(param_sets):
    from repro_torch.core.fleet import stack_params
    ports = [p for _, p in param_sets]
    stacked = stack_params(ports)
    assert stacked.datadep.shape == (2, 4, 2, 3)
    for i, p in enumerate(ports):
        for a, b in zip(stacked.select(i), p):
            assert torch.equal(a, b)
    sub = stacked.select([1])
    assert sub.i2n.shape == (1,)
    np.testing.assert_allclose(float(ports[0].i3n),
                               float(param_sets[0][0].i3n), rtol=1e-6)
