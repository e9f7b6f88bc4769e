"""Weights across the two packages: the committed schema-v2 model read by
both loaders gives equal float32 leaves and matching estimates; a fit of
the reference round-trips reference -> port -> reference through v2
files; the numpy converters; and the port's independence from JAX and
from the reference package."""
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.core import device_sim
from repro.core import model_api as rma
from repro.core import traces as rtraces
from repro_torch import convert
from repro_torch.core import dram as pdram
from repro_torch.core import model_api as pma
from repro_torch.core.baselines_power import DRAMPowerModel, MicronModel
from repro_torch.core.vampire import Vampire

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL = ROOT / "src" / "repro_torch" / "data" / "vampire_quickfit_v2.npz"
RTOL = 1e-5


def _bridge(tr):
    return pdram.make_trace(*[np.asarray(f) for f in tr])


@pytest.fixture(scope="module")
def traces():
    trs = [rtraces.app_trace(rtraces.SPEC_APPS[i], n_requests=n)
           for i, n in ((3, 70), (8, 50), (20, 40))]
    return trs, [_bridge(t) for t in trs]


def _assert_same_model(ref, port):
    rf, pf = ref.fleet, port.fleet
    for name, a, b in zip(rf.params._fields, rf.params, pf.params):
        b = b.numpy()
        assert b.dtype == np.float32, name
        np.testing.assert_array_equal(b, np.asarray(a, np.float32),
                                      err_msg=name)
    np.testing.assert_array_equal(pf.band.numpy(), np.asarray(rf.band))
    np.testing.assert_array_equal(pf.idd_datasheet.numpy(),
                                  np.asarray(rf.idd_datasheet))
    np.testing.assert_array_equal(pf.vendor_ids.numpy(),
                                  np.asarray(rf.vendor_ids))
    assert port.vendors == ref.vendors


def _assert_same_estimates(ref, port, traces):
    trs, ptrs = traces
    for mode, kw in (("mean", {}), ("surface", {}),
                     ("distribution", dict(ones_frac=0.4, toggle_frac=0.2))):
        a = ref.estimate(trs, mode=mode, **kw)
        b = port.estimate(ptrs, mode=mode, impl="cuda", **kw)
        for name, la, lb in zip(a._fields, a, b):
            np.testing.assert_allclose(lb.numpy(), np.asarray(la),
                                       rtol=RTOL, err_msg=f"{mode} {name}")


def test_committed_model_loads_equal_in_both_packages(traces):
    ref = rma.load_estimator(str(MODEL))
    port = pma.load_estimator(str(MODEL), device="cpu")
    assert isinstance(port, Vampire) and port.device == torch.device("cpu")
    _assert_same_model(ref, port)
    _assert_same_estimates(ref, port, traces)
    assert pma.read_manifest(str(MODEL)) == rma.read_manifest(str(MODEL))


def test_fit_round_trips_between_packages(quick_vampire, traces, tmp_path):
    """reference fit -> reference save -> port load; then port save ->
    reference load: the same leaves and estimates both ways."""
    first, second = tmp_path / "ref.npz", tmp_path / "port.npz"
    rma.save_estimator(quick_vampire, str(first))
    port = Vampire.load(str(first), device="cpu")
    _assert_same_model(quick_vampire, port)
    _assert_same_estimates(quick_vampire, port, traces)
    port.save(str(second), meta={"via": "port"})
    back = rma.load_estimator(str(second))
    _assert_same_model(back, port)
    _assert_same_estimates(back, port, traces)
    assert rma.read_manifest(str(second))["meta"] == {"via": "port"}
    np.testing.assert_array_equal(
        np.load(str(second))["datadep_r2"], np.load(str(first))["datadep_r2"])


@pytest.mark.parametrize("cls", [MicronModel, DRAMPowerModel])
def test_baseline_files_round_trip(cls, traces, tmp_path):
    from repro.core import baselines_power as rbp
    ref = rbp.BASELINE_MODELS[cls.kind].from_vampire(
        rma.load_estimator(str(MODEL)))
    rma.save_estimator(ref, str(tmp_path / "ref.npz"))
    port = cls.load(str(tmp_path / "ref.npz"), device="cpu")
    np.testing.assert_array_equal(port.idd_table.numpy(),
                                  np.asarray(ref.idd_table))
    port.save(str(tmp_path / "port.npz"))
    back = rma.load_estimator(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back.idd_table),
                                  port.idd_table.numpy())
    trs, ptrs = traces
    np.testing.assert_allclose(
        port.estimate(ptrs, impl="cuda").energy_pj.numpy(),
        np.asarray(ref.estimate(trs).energy_pj), rtol=RTOL)
    with pytest.raises(TypeError, match="not a Vampire"):
        Vampire.load(str(tmp_path / "port.npz"), device="cpu")


def test_v1_pickles_are_left_to_the_reference():
    with pytest.raises(ValueError, match="schema-v2"):
        pma.load_estimator(str(ROOT / "artifacts" / "vampire_fit_v1.pkl"),
                           device="cpu")
    assert pma.read_manifest(str(ROOT / "artifacts"
                                 / "vampire_fit_v1.pkl")) is None


def test_power_params_from_numpy_single_and_stacked():
    from repro.core.fleet import stack_params
    sets = [device_sim.true_vendor_params(v) for v in range(3)]
    for ref in (sets[1], stack_params(sets)):
        leaves = {n: np.asarray(x) for n, x in zip(ref._fields, ref)}
        got = convert.power_params_from_numpy(leaves)
        for name, a, b in zip(ref._fields, ref, got):
            assert b.shape == np.shape(a) and b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a, np.float32),
                                          err_msg=name)
    # the optional leaves default as the NamedTuple does
    leaves = {n: np.asarray(x) for n, x in zip(sets[0]._fields, sets[0])}
    for name in ("act_surface", "i_pd_slow", "i_actpd", "i_sr"):
        del leaves[name]
    got = convert.power_params_from_numpy(leaves)
    assert torch.equal(got.act_surface, torch.ones(8, 8))
    assert float(got.i_sr) == 0.0
    with pytest.raises(KeyError, match="datadep"):
        convert.power_params_from_numpy({"i2n": np.float32(1.0)})


def test_fitted_transform_defaults_like_the_reference_loader():
    """A file written before the low-power LUT and the surface existed
    loads with i_pd in their place and the neutral surface, as the
    reference's ``_rebuild_vendor`` + ``build_params`` do."""
    with np.load(str(MODEL)) as npz:
        fitted = {f: np.asarray(npz[f]) for f in
                  ("datadep", "i2n", "bank_open_delta", "bank_read_factor",
                   "bank_write_factor", "q_actpre", "row_ones_slope",
                   "q_ref", "i_pd")}
    leaves = convert.params_from_fitted(fitted)
    for name in ("i_pd_slow", "i_actpd", "i_sr"):
        np.testing.assert_array_equal(leaves[name],
                                      fitted["i_pd"].astype(np.float32))
    np.testing.assert_array_equal(leaves["act_surface"],
                                  np.ones((3, 8, 8), np.float32))
    np.testing.assert_array_equal(leaves["ones_quad"], np.zeros(3))
    np.testing.assert_array_equal(leaves["io_read_ma_per_one"],
                                  np.full(3, 0.40, np.float32))
    np.testing.assert_array_equal(leaves["io_write_ma_per_zero"],
                                  np.full(3, 0.39, np.float32))
    assert all(x.dtype == np.float32 for x in leaves.values())


def test_port_imports_neither_jax_nor_the_reference():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                         r"from\s+repro\b(?!_)|import\s+repro\b(?!_))",
                         re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert hits == []
    assert pattern.search("from repro.core import dram")
    assert pattern.search("import jax.numpy as jnp")
    assert not pattern.search("from repro_torch.core import dram")


def test_vampire_params_per_vendor_equal_the_reference(quick_vampire,
                                                       tmp_path):
    """``Vampire.params(vendor)`` (what the HBM extrapolation reads) gives
    the reference's fitted leaves for every vendor of the quick fit, and of
    the committed file; an unknown vendor raises ``KeyError`` as the
    reference's dict lookup does."""
    path = tmp_path / "fit.npz"
    rma.save_estimator(quick_vampire, str(path))
    for ref, port in ((quick_vampire, Vampire.load(str(path), device="cpu")),
                      (rma.load_estimator(str(MODEL)),
                       pma.load_estimator(str(MODEL), device="cpu"))):
        for v in ref.vendors:
            want, got = ref.params(v), port.params(v)
            for name, a, b in zip(want._fields, want, got):
                np.testing.assert_array_equal(
                    b.numpy(), np.asarray(a, np.float32), err_msg=name)
        with pytest.raises(KeyError):
            port.params(max(port.vendors) + 1)


def test_saving_a_loaded_model_writes_back_what_it_read(traces, tmp_path):
    """The port's load and save of the committed quick fit keep every
    entry of the file, float64 and raw campaign arrays included, and the
    manifest's R^2 maps and ``raw``; the reference reads the port's file
    and estimates bit for bit as from the original."""
    out = tmp_path / "port.npz"
    port = pma.load_estimator(str(MODEL), device="cpu")
    port.save(str(out))
    with np.load(str(MODEL)) as a, np.load(str(out)) as b:
        assert len(a.files) == 156 and sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            assert np.array_equal(a[name], b[name]), name
    want, got = rma.read_manifest(str(MODEL)), pma.read_manifest(str(out))
    for key in ("idd_r2", "row_r2", "raw"):
        assert got[key] == want[key], key
    assert want["raw"] is True
    ref, back = rma.load_estimator(str(MODEL)), rma.load_estimator(str(out))
    trs, _ = traces
    for mode in ("mean", "surface"):
        for la, lb in zip(ref.estimate(trs, mode=mode),
                          back.estimate(trs, mode=mode)):
            np.testing.assert_array_equal(np.asarray(lb), np.asarray(la))
    # a model built in the port (nothing loaded to keep) writes its
    # float32 leaves, which the reference reads back to the same estimates
    built = dataclasses.replace(port, saved=None)
    built.save(str(tmp_path / "built.npz"))
    _assert_same_estimates(rma.load_estimator(str(tmp_path / "built.npz")),
                           built, traces)
    assert not pma.read_manifest(str(tmp_path / "built.npz"))["raw"]
