"""The port's simulated rig against the reference's: every parameter
table, the fleets, the Threefry draws (bits equal to JAX's), the true
module parameters (bit for bit, numpy ``SeedSequence``), the synthetic
fleets, the measurement noise and the drift (float32 normals through
XLA's erfinv polynomial: rtol 1e-6 for the normals, 1e-5 downstream),
and the multimeter's ``measure_current``.

Every test that draws through the reference runs under
``jax.threefry_partitionable(True)``: the port follows JAX's partitionable
Threefry stream, the default from JAX 0.5 but not under JAX 0.4.x, so the
stream is pinned for the test's duration."""
import jax
import numpy as np
import pytest
import torch

from repro.core import device_sim as rsim
from repro.core import idd_loops as ridd
from repro.core import params as rparams
from repro_torch.core import device_sim as psim
from repro_torch.core import dram as pdram
from repro_torch.core import params as pparams
from repro_torch.core import threefry

RTOL = 1e-5
CONSTANTS = sorted(n for n in vars(rparams)
                   if n.isupper() and not n.startswith("_"))
SPECS = ([rparams.ModuleSpec(v, i, 2015) for v in range(3) for i in range(3)]
         + rparams.generational_fleet())


@pytest.fixture(autouse=True)
def partitionable():
    # pin JAX's partitionable Threefry stream (the port's) for this test
    with jax.threefry_partitionable(True):
        yield


def _equal_values(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal_values(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _leaves(pp):
    return {n: np.asarray(x) for n, x in zip(pp._fields, pp)}


def _assert_params(ref, port, exact: bool, what=""):
    for name, a in _leaves(ref).items():
        b = getattr(port, name).cpu().numpy()
        assert b.dtype == np.float32, name
        if exact:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", CONSTANTS)
def test_parameter_tables_equal_the_reference(name):
    assert hasattr(pparams, name), name
    _equal_values(getattr(rparams, name), getattr(pparams, name))


def test_fleets_and_datasheet_ids_equal_the_reference():
    assert [tuple(s) for s in pparams.paper_fleet()] == \
        [tuple(s) for s in rparams.paper_fleet()]
    assert [tuple(s) for s in pparams.generational_fleet()] == \
        [tuple(s) for s in rparams.generational_fleet()]
    assert len(pparams.paper_fleet()) == 50
    for key in set(rparams.MEASURED_IDD) & set(
            rparams.MEASURED_OVER_DATASHEET):
        for v in range(3):
            assert pparams.datasheet_idd(key, v) == \
                rparams.datasheet_idd(key, v)


@pytest.mark.parametrize("seed", [0, 0x5EED, 0xF1EE7, 0xD81F7, 0xFFFFFFFF])
def test_threefry_bits_equal_jax(seed):
    """Keys, ``fold_in`` chains and the partitionable random bits are
    JAX's, bit for bit; the uniforms too (float32 arithmetic only)."""
    data = np.array([0, 1, 2, 7, 2015, 4096, (1 << 20) + 3, 0xFFFFFFFF],
                    np.uint32)
    rk = jax.random.key(seed)
    pk = threefry.key(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(rk)),
        np.concatenate([pk[0], pk[1]]))
    for d in data:
        rk2 = jax.random.fold_in(jax.random.fold_in(rk, d), 3)
        pk2 = threefry.fold_in(threefry.fold_in(pk, d), 3)
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(rk2)),
                                      np.concatenate(pk2))
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(rk2, (37,), np.uint32)),
            threefry.random_bits(pk2, 37)[0])
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(rk2, (37,), maxval=2 * np.pi)),
            threefry.uniform(pk2, 37, 0.0, 2 * np.pi)[0])
    # one vectorized fold_in over many data words == one at a time
    many = threefry.fold_in(pk, data)
    for i, d in enumerate(data):
        one = threefry.fold_in(pk, d)
        assert many[0][i] == one[0][0] and many[1][i] == one[1][0]


def test_normals_match_jax():
    """F8 repaired: the port computes erfinv with XLA's float32 polynomial,
    so the normals agree at rtol 1e-6 (measured worst 2.3e-7: only
    ``log1p``'s last bit differs between libraries), most bit for bit."""
    ids = np.arange(400, dtype=np.uint32)
    pk = threefry.fold_in(threefry.key(0x5EED), ids)
    got = threefry.normal(pk, 13)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0x5EED), i))(
        ids)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (13,)))(keys))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.mean(got == want) > 0.9


@pytest.mark.parametrize("vendor", [0, 1, 2])
def test_structural_surface_and_vendor_params_are_bit_for_bit(vendor):
    np.testing.assert_array_equal(psim.structural_surface(vendor),
                                  rsim.structural_surface(vendor))
    for year in (2011, 2012, 2015):
        _assert_params(rsim.true_vendor_params(vendor, year),
                       psim.true_vendor_params(vendor, year), exact=True,
                       what=f"vendor {vendor} year {year}")


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_true_module_params_are_bit_for_bit(spec):
    _assert_params(rsim.true_module_params(spec),
                   psim.true_module_params(pparams.ModuleSpec(*spec)),
                   exact=True, what=str(spec))


def test_synthetic_fleet_matches_the_reference():
    rv, rs = rsim.synth_fleet_params(31)
    pv, ps = psim.synth_fleet_params(31, device="cpu")
    np.testing.assert_array_equal(pv, rv)
    _assert_params(rs, ps, exact=False)
    # pinned vendors and ids, another year
    vendors = np.array([2, 2, 0, 1, 1], np.uint32)
    ids = np.array([9, 400, 3, 3, 77], np.uint32)
    rv, rs = rsim.synth_fleet_params(vendors=vendors, module_ids=ids,
                                     year=2012)
    pv, ps = psim.synth_fleet_params(vendors=vendors, module_ids=ids,
                                     year=2012, device="cpu")
    np.testing.assert_array_equal(pv, rv)
    _assert_params(rs, ps, exact=False)
    # a module's params do not depend on the fleet around it
    _, small = psim.synth_fleet_params(7, device="cpu")
    _, big = psim.synth_fleet_params(31, device="cpu")
    for a, b in zip(small, big):
        torch.testing.assert_close(a, b[:7], rtol=0, atol=0)
    with pytest.raises(ValueError, match="n_modules"):
        psim.synth_fleet_params(device="cpu")


def test_measurement_noise_matches_the_reference():
    keys = [0, 5, 17, 4096, 4096 + 347, (1 << 20) + 2]
    want = rsim.measurement_noise_factors(SPECS, keys)
    got = psim.measurement_noise_factors(SPECS, keys)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # one module at a time gives the matrix's own entries
    for i, s in enumerate(SPECS[:4]):
        for j, k in enumerate(keys):
            assert psim.measurement_noise_factors([s], [k])[0, 0] == \
                got[i, j]


def test_measure_current_matches_the_reference():
    """``skip``, ``probe_key`` and the ad-hoc counter, at rtol 1e-5."""
    spec = rparams.ModuleSpec(2, 1, 2015)
    rmod = rsim.SimulatedModule(spec)
    pmod = psim.SimulatedModule(pparams.ModuleSpec(*spec))
    loops = [ridd.bank_idle_probe(3), (ridd.idd2n(), 0)]
    for tr, skip in loops:
        ptr = pdram.make_trace(*[np.asarray(f) for f in tr])
        for noisy, key in ((False, None), (True, 4100), (True, None)):
            want = rmod.measure_current(tr, noisy=noisy, skip=skip,
                                        probe_key=key)
            got = pmod.measure_current(ptr, noisy=noisy, skip=skip,
                                       probe_key=key)
            np.testing.assert_allclose(got, want, rtol=RTOL)
    # unkeyed calls advance the counter, keyed calls repeat
    tr = pdram.make_trace(*[np.asarray(f) for f in ridd.idd2n()])
    assert pmod.measure_current(tr, probe_key=7) == \
        pmod.measure_current(tr, probe_key=7)
    assert pmod.measure_current(tr) != pmod.measure_current(tr)
    rep = pmod.measure_report(tr)
    np.testing.assert_allclose(float(rep.avg_current_ma),
                               pmod.measure_current(tr, noisy=False),
                               rtol=1e-6)


def test_make_fleet_and_vendor_modules():
    fleet = psim.make_fleet()
    assert [tuple(m.spec) for m in fleet] == \
        [tuple(s) for s in rparams.paper_fleet()]
    assert [len(psim.vendor_modules(fleet, v)) for v in range(3)] == \
        [14, 13, 23]


@pytest.mark.parametrize("drift", [
    rsim.DEFAULT_DRIFT, rsim.NO_DRIFT,
    rsim.DriftProcess(step_tick=5, step_frac=0.07)], ids=str)
def test_drift_matches_the_reference(drift):
    pdrift = psim.DriftProcess(**vars(drift))
    vendors, ids = [0, 1, 2, 2, 1], [0, 3, 7, 400, 12]
    for tick in (0, 1, 6, 95, 250):
        rbg, ract = rsim.drift_factors(vendors, ids, tick, drift)
        pbg, pact = psim.drift_factors(vendors, ids, tick, pdrift)
        np.testing.assert_allclose(pbg, rbg, rtol=RTOL)
        np.testing.assert_allclose(pact, ract, rtol=RTOL)
    spec = rparams.ModuleSpec(1, 4, 2015)
    _assert_params(rsim.drifted_module_params(spec, 40, drift),
                   psim.drifted_module_params(pparams.ModuleSpec(*spec), 40,
                                              pdrift), exact=False)
    fleet = psim.make_fleet([pparams.ModuleSpec(*s) for s in SPECS[:3]])
    drifted = psim.drifted_fleet(fleet, 12, pdrift)
    for m, d in zip(fleet, drifted):
        assert d.spec == m.spec and d is not m
        _assert_params(rsim.drifted_module_params(m.spec, 12, drift),
                       d.params, exact=False)
