"""The golden matrix of the slice: 3 estimator kinds x 4 modes x every
port impl (``vectorized``, ``reference``, ``cuda`` — the last through the
kernels' plain versions on CPU tensors) against the reference's
``vectorized`` estimate of the same model on the same ragged traces,
leaf by leaf at rtol 1e-5; vendor subsets; exact padding; surface summing
to mean; the registry and argument contract; the device rule."""
import pathlib

import numpy as np
import pytest
import torch

from repro.core import dram as rdram
from repro.core import model_api as rma
from repro.core import traces as rtraces
from repro_torch.core import dram as pdram
from repro_torch.core import idd_loops
from repro_torch.core import estimate_batch as pbatch
from repro_torch.core import model_api as pma

RTOL = 1e-5
MODEL = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "data" / "vampire_quickfit_v2.npz")
MODES = ("mean", "range", "distribution", "surface")
KINDS = ("vampire", "micron", "drampower")
IMPLS = ("vectorized", "reference", "cuda")
MODE_KW = {"distribution": dict(ones_frac=0.35, toggle_frac=0.15)}
_T = rdram.TIMING


def _bridge(tr):
    return pdram.make_trace(*[np.asarray(f) for f in tr])


def _to_ref(tr):
    """A port trace (the port's generators) as the reference's."""
    return rdram.make_trace(*[f.numpy() for f in tr[:4]],
                            tr.data.numpy().view(np.uint32), tr.dt.numpy())


def _pde_trace():
    P = rdram
    return rdram.make_trace(
        [P.ACT, P.RD, P.RD, P.PREA, P.PDE, P.PDX, P.ACT, P.WR, P.PRE],
        [0, 0, 0, 0, 0, 0, 2, 2, 2], [5, 5, 5, 0, 0, 0, 9, 9, 0],
        [0, 0, 1, 0, 0, 0, 0, 3, 0], None,
        [_T.tRCD, _T.tCCD, _T.tCCD, _T.tRP, 200, _T.tCKE, _T.tRCD,
         _T.tBURST, _T.tRP])


def _lowpower_trace():
    P = rdram
    return rdram.make_trace(
        [P.ACT, P.RD, P.PREA, P.PDE, P.NOP, P.PDX, P.PDE_SLOW, P.NOP, P.PDX,
         P.ACT, P.PDE, P.NOP, P.PDX, P.PREA, P.SRE, P.NOP, P.SRX, P.ACT,
         P.WR, P.PRE],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 3, 3, 3, 3, 0, 0, 0, 1, 1, 1],
        [5, 5, 0, 0, 0, 0, 0, 0, 0, 9, 9, 9, 9, 0, 0, 0, 0, 2, 2, 0],
        [0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 0], None,
        [_T.tRCD, _T.tBURST, _T.tRP, _T.tCKE, 120, _T.tXP, _T.tCKE, 300,
         _T.tXPDLL, _T.tRCD, _T.tCKE, 180, _T.tXP, _T.tRP, _T.tCKE, 900,
         _T.tXS, _T.tRCD, _T.tBURST, _T.tRP])


@pytest.fixture(scope="module")
def ragged():
    trs = [rtraces.app_trace(rtraces.SPEC_APPS[i], n_requests=n)
           for i, n in ((0, 90), (4, 150))]
    trs += [_to_ref(idd_loops.validation_sweep(24)), _pde_trace(),
            _lowpower_trace()]
    return trs, [_bridge(t) for t in trs]


@pytest.fixture(scope="module")
def estimators():
    from repro.core.baselines_power import DRAMPowerModel, MicronModel
    rv = rma.load_estimator(str(MODEL))
    pv = pma.load_estimator(str(MODEL), device="cpu")
    ref = {"vampire": rv, "micron": MicronModel.from_vampire(rv),
           "drampower": DRAMPowerModel.from_vampire(rv)}
    port = {k: pma.make_estimator(k, pv) for k in KINDS}
    return ref, port


@pytest.fixture(scope="module")
def golden(estimators, ragged):
    """The reference's vectorized reports of every (kind, mode)."""
    ref, _ = estimators
    trs, _ = ragged
    return {(k, m): ref[k].estimate(trs, mode=m, **MODE_KW.get(m, {}))
            for k in KINDS for m in MODES}


def _reports(rep, mode):
    return rep if mode == "range" else (rep,)


def _assert_reports(got, want, mode, what, rtol=RTOL):
    for g, w in zip(_reports(got, mode), _reports(want, mode)):
        for name, lg, lw in zip(g._fields, g, w):
            if name == "cycles":
                np.testing.assert_array_equal(lg.numpy(), np.asarray(lw),
                                              err_msg=f"{what} {name}")
            else:
                np.testing.assert_allclose(lg.numpy(), np.asarray(lw),
                                           rtol=rtol,
                                           err_msg=f"{what} {name}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_golden_matrix(estimators, ragged, golden, kind, mode, impl):
    _, port = estimators
    _, ptrs = ragged
    got = port[kind].estimate(ptrs, mode=mode, impl=impl,
                              **MODE_KW.get(mode, {}))
    shape = ((len(ptrs), 3, 8, 8) if mode == "surface" else (len(ptrs), 3))
    assert _reports(got, mode)[0].energy_pj.shape == shape
    assert _reports(got, mode)[0].energy_pj.dtype == torch.float32
    assert _reports(got, mode)[0].cycles.dtype == torch.int32
    _assert_reports(got, golden[kind, mode], mode, f"{kind}/{mode}/{impl}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_vendor_subsets(estimators, ragged, kind, impl):
    ref, port = estimators
    trs, ptrs = ragged
    want = ref[kind].estimate(trs, (2, 0))
    got = port[kind].estimate(ptrs, (2, 0), impl=impl)
    _assert_reports(got, want, "mean", f"{kind}/{impl} vendors (2, 0)")
    one = port[kind].estimate(ptrs, 1, impl=impl)
    assert one.energy_pj.shape == (len(ptrs), 1)
    with pytest.raises(KeyError, match="not fitted"):
        port[kind].estimate(ptrs, (7,), impl=impl)


def test_per_trace_fractions_in_distribution_mode(estimators, ragged):
    ref, port = estimators
    trs, ptrs = ragged
    of = np.linspace(0.1, 0.9, len(trs)).astype(np.float32)
    tf = np.linspace(0.4, 0.05, len(trs)).astype(np.float32)
    want = ref["vampire"].estimate(trs, mode="distribution", ones_frac=of,
                                   toggle_frac=tf)
    for impl in IMPLS:
        got = port["vampire"].estimate(
            ptrs, mode="distribution", impl=impl,
            data=pma.DataProfile(ones_frac=of, toggle_frac=tf))
        _assert_reports(got, want, "mean", f"per-trace fractions {impl}")


@pytest.mark.parametrize("impl", ("vectorized", "cuda"))
@pytest.mark.parametrize("kind", KINDS)
def test_padding_is_exact_and_surface_sums_to_mean(estimators, ragged, kind,
                                                   impl):
    """Pad commands (NOP, dt=0) and zero-weight pad rows add nothing, per
    report leaf and per surface cell; the surface sums to the mean."""
    _, port = estimators
    _, ptrs = ragged
    est = port[kind]
    mean = est.estimate(ptrs, impl=impl)
    bucket = pbatch.bucketed_trace_batch(ptrs, len(ptrs) + 3, 1024)
    padded = est.estimate(bucket, impl=impl)
    _assert_reports(padded.__class__(*(x[:len(ptrs)] for x in padded)),
                    mean, "mean", f"{kind}/{impl} bucketed")
    assert float(padded.charge_ma_cycles[len(ptrs):].abs().sum()) == 0.0
    assert int(padded.cycles[len(ptrs):].abs().sum()) == 0
    surf = est.estimate(bucket, mode="surface", impl=impl)
    np.testing.assert_allclose(surf.charge_ma_cycles.sum((-2, -1)).numpy(),
                               padded.charge_ma_cycles.numpy(), rtol=RTOL)
    assert torch.equal(surf.cycles.sum((-2, -1)), padded.cycles)
    solo = est.estimate([ptrs[1]], impl=impl)
    np.testing.assert_allclose(solo.energy_pj[0].numpy(),
                               mean.energy_pj[1].numpy(), rtol=RTOL)


def test_range_band_and_baseline_collapse(estimators, ragged):
    _, port = estimators
    _, ptrs = ragged
    lo, mean, hi = port["vampire"].estimate(ptrs, mode="range", impl="cuda")
    band = port["vampire"].fleet.band
    np.testing.assert_allclose(lo.energy_pj.numpy(),
                               (mean.energy_pj * band[:, 0]).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(hi.avg_current_ma.numpy(),
                               (mean.avg_current_ma * band[:, 1]).numpy(),
                               rtol=1e-6)
    assert torch.equal(lo.time_ns, mean.time_ns)
    rep = port["micron"].estimate(ptrs, mode="range", impl="cuda")
    assert rep[0] is rep[1] is rep[2]


def test_registry_and_argument_contract(estimators, ragged):
    _, port = estimators
    _, ptrs = ragged
    assert pma.resolve_impl("scan").name == "reference"
    assert set(pma.registered_impls()) == {"vectorized", "reference",
                                           "cuda"}
    with pytest.raises(ValueError, match="unknown impl"):
        pma.resolve_impl("pallas")
    assert pma.impl_execution_mode("cuda", "cpu") == "plain"
    assert pma.impl_execution_mode("cuda", "cuda") == "kernel"
    assert pma.impl_execution_mode("vectorized", "cpu") == "torch"
    extra = pma.register_impl(pma.EstimateImpl("no-path", "probe",
                                               modes=("mean",)))
    try:
        with pytest.raises(ValueError, match="does not support mode"):
            pma.resolve_impl("no-path", mode="surface")
        for est in port.values():
            with pytest.raises(ValueError, match="no evaluation path"):
                est.estimate(ptrs, impl=extra.name)
    finally:
        pma._IMPLS.pop("no-path")
    est = port["vampire"]
    with pytest.raises(ValueError, match="requires ones_frac"):
        est.estimate(ptrs, mode="distribution")
    with pytest.raises(ValueError, match="only meaningful"):
        est.estimate(ptrs, ones_frac=0.5, toggle_frac=0.5)
    with pytest.raises(ValueError, match="not both"):
        est.estimate(ptrs, mode="distribution", ones_frac=0.5,
                     data=pma.DataProfile(0.5, 0.5))
    with pytest.raises(TypeError, match="DataProfile"):
        est.estimate(ptrs, mode="distribution", data=(0.5, 0.5))
    with pytest.raises(ValueError, match="unknown mode"):
        est.estimate(ptrs, mode="median")


def test_batch_cache_reuses_padded_batches(estimators, ragged):
    _, port = estimators
    _, ptrs = ragged
    est = port["drampower"]
    a = est._batch_cache.get(ptrs)
    assert est._batch_cache.get(list(ptrs)) is a
    assert est._batch_cache.get(ptrs[:2]) is not a
    assert est._batch_cache.get(a) is a


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch,
                                                          estimators):
    """Without a card and without ``device='cpu'`` the entry points raise
    rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pma.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pma.load_estimator(str(MODEL))
    _, port = estimators
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port["vampire"].to("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pma.make_estimator("micron", port["vampire"]).to(None)
    assert pma.resolve_device("cpu") == torch.device("cpu")
    assert port["micron"].device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown estimator kind"):
        pma.make_estimator("ddr5", port["vampire"])


# ---------------------------------------------------------------------------
# Addresses outside the module, and batches of empty traces
# ---------------------------------------------------------------------------
def _address_trace(bank: int, row: int, make):
    """ACT/PRE on bank 0, then ACT, RD, PRE on ``bank`` at ``row``: the
    first out-of-range command, if any, is command 2."""
    P = rdram
    return make([P.ACT, P.PRE, P.ACT, P.RD, P.PRE], [0, 0, bank, bank, bank],
                [0, 0, row, row, 0], [0, 0, 0, 1, 0], None,
                [_T.tRCD, _T.tRP, _T.tRCD, _T.tBURST, _T.tRP])


def _direct_trace(cmds, banks, rows, cols, data, dts):
    """A CommandTrace built field by field, without ``make_trace``."""
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    return pdram.CommandTrace(i32(cmds), i32(banks), i32(rows), i32(cols),
                              torch.zeros((len(cmds), 16), dtype=torch.int32),
                              i32(dts))


BAD_ADDRESSES = [(9, 5, "bank 9 outside \\[0, 8\\)"),
                 (-1, 5, "bank -1 outside \\[0, 8\\)"),
                 (1, 40000, "row 40000 outside \\[0, 32768\\)"),
                 (1, -5, "row -5 outside \\[0, 32768\\)")]


@pytest.mark.parametrize("mode", ("mean", "surface"))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bank,row,what", BAD_ADDRESSES)
def test_addresses_outside_the_module_are_refused(estimators, ragged, kind,
                                                  impl, mode, bank, row,
                                                  what):
    """Every impl refuses a bank outside [0, 8) or a row outside [0, 2^15)
    alike, naming the trace and the command, whether the trace comes from
    ``make_trace`` or is built directly and handed to ``estimate``."""
    _, port = estimators
    _, ptrs = ragged
    with pytest.raises(ValueError, match=f"trace 0, command 2: {what}"):
        _address_trace(bank, row, pdram.make_trace)
    bad = _address_trace(bank, row, _direct_trace)
    with pytest.raises(ValueError, match=f"trace 1, command 2: {what}"):
        port[kind].estimate([ptrs[0], bad], mode=mode, impl=impl)
    with pytest.raises(ValueError, match=f"trace 2, command 2: {what}"):
        pbatch.bucketed_trace_batch([ptrs[0], ptrs[1], bad], 4, 2048)


@pytest.mark.parametrize("mode", ("mean", "surface"))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", KINDS)
def test_last_bank_and_row_agree_with_the_reference(estimators, kind, impl,
                                                    mode):
    ref, port = estimators
    want = ref[kind].estimate([_address_trace(7, 32767, rdram.make_trace)],
                              mode=mode)
    got = port[kind].estimate([_address_trace(7, 32767, pdram.make_trace)],
                              mode=mode, impl=impl)
    _assert_reports(got, want, mode, f"{kind}/{mode}/{impl} bank 7 row 32767")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_a_batch_of_empty_traces_gives_zeros(estimators, kind, mode, impl):
    ref, port = estimators
    empty = ([], [], [], [], None, [])
    kw = MODE_KW.get(mode, {})
    want = ref[kind].estimate([rdram.make_trace(*empty)] * 2, mode=mode, **kw)
    got = port[kind].estimate([pdram.make_trace(*empty)] * 2, mode=mode,
                              impl=impl, **kw)
    for g, w in zip(_reports(got, mode), _reports(want, mode)):
        for name, lg, lw in zip(g._fields, g, w):
            assert lg.shape == np.asarray(lw).shape, name
            assert not lg.any() and not np.asarray(lw).any(), name
    _assert_reports(got, want, mode, f"{kind}/{mode}/{impl} empty traces")


@pytest.mark.parametrize("impl", ("vectorized", "cuda"))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_a_box_with_its_batch_config_gives_the_batch_rows(estimators, ragged,
                                                          kind, mode, impl):
    """A sharded dispatch's box, estimated with the whole batch's
    ``config={"batch": ..., "first_trace": ...}``, is the batch's rows bit
    for bit on every impl that takes a config (on the CPU; on a card
    ``tests/test_torch_cuda.py`` holds the same)."""
    from repro_torch.core.dram import CommandTrace
    from repro_torch.kernels.common import batch_rows
    _, port = estimators
    _, trs = ragged
    kw = MODE_KW.get(mode, {})
    tb = pbatch.TraceBatch.from_traces(trs)
    whole = port[kind].estimate(tb, mode=mode, impl=impl, **kw)
    n, v = tb.n_traces, len(port[kind].vendors)
    for rows in (slice(0, 2), slice(2, 3), slice(3, 5)):
        box = pbatch.TraceBatch(CommandTrace(*(x[rows] for x in tb.trace)),
                                tb.weight[rows])
        config = {"batch": (n, v), "first_trace": rows.start}
        assert batch_rows(config) == (rows.start, n)
        got = port[kind].estimate(box, mode=mode, impl=impl, config=config,
                                  **kw)
        for g, w in zip(_reports(got, mode), _reports(whole, mode)):
            for name, lg, lw in zip(g._fields, g, w):
                assert torch.equal(lg, lw[rows]), (rows, name)
    assert batch_rows(None) is None and batch_rows({"max_cluster": 2}) is None
