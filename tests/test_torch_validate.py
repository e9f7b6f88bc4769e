"""The port's model validation (``repro_torch.core.validate``, paper
Section 9.1, Fig 14 and Figs 19-22) against the reference's: the same
held-out modules, ``run_validation``'s MAPEs and raw numbers at rtol 1e-5
on the 9-module tiny fleet with a cut sweep, any estimator riding along,
the structural surface maps of all three kinds at rtol 1e-5, Fig 14's
ratios at rtol 1e-6 on the model carried across by the schema-v2 file,
and the renderers' text.  Draws through the reference run under
``jax.threefry_partitionable(True)``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import model_api as rma
from repro.core import validate as RV
from repro_torch.core import device_sim as psim
from repro_torch.core import model_api as pma
from repro_torch.core import params as pparams
from repro_torch.core import validate as V
from repro_torch.core.vampire import Vampire

RTOL = 1e-5
N_VALUES = (0, 2, 8, 16, 64, 256, 764)
SPECS = [pparams.ModuleSpec(v, i, 2015) for v in range(3) for i in range(3)]


@pytest.fixture(autouse=True)
def partitionable():
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
    path = tmp_path_factory.mktemp("validate") / "quick.npz"
    rma.save_estimator(quick_vampire, str(path))
    return pma.load_estimator(str(path), device="cpu")


@pytest.fixture(scope="module")
def reference(quick_vampire, tiny_fleet):
    with jax.threefry_partitionable(True):
        return RV.run_validation(quick_vampire, fleet=tiny_fleet,
                                 n_values=N_VALUES)


def _specs(mods):
    return [tuple(m.spec) for m in mods]


@pytest.mark.parametrize("seed", [42, 7])
def test_selected_modules_equal_the_reference(tiny_fleet, seed):
    assert _specs(V.select_validation_modules(seed=seed)) == \
        _specs(RV.select_validation_modules(seed=seed))
    assert _specs(V.select_validation_modules(psim.make_fleet(SPECS),
                                              seed=seed)) == \
        _specs(RV.select_validation_modules(tiny_fleet, seed=seed))
    assert V.N_READS == RV.N_READS
    assert V.VALIDATION_COUNTS == RV.VALIDATION_COUNTS
    assert V._VALIDATION_KEY_BASE == RV._VALIDATION_KEY_BASE


@pytest.mark.parametrize("impl", ["vectorized", "cuda"])
def test_run_validation_matches_the_reference(model, reference, impl):
    got = V.run_validation(model, fleet=psim.make_fleet(SPECS),
                           n_values=N_VALUES, impl=impl)
    assert list(got.raw) == list(reference.raw)
    for key, row in reference.raw.items():
        assert list(got.raw[key]) == list(row)
        np.testing.assert_allclose(list(got.raw[key].values()),
                                   list(row.values()), rtol=RTOL,
                                   err_msg=str(key))
    assert list(got.mape) == list(reference.mape) == \
        ["vampire", "drampower", "micron"]
    for name, per_v in reference.mape.items():
        assert list(got.mape[name]) == list(per_v)
        np.testing.assert_allclose(list(got.mape[name].values()),
                                   list(per_v.values()), rtol=RTOL)
        np.testing.assert_allclose(got.mape_mean[name],
                                   reference.mape_mean[name], rtol=RTOL)


def test_vampire_beats_baselines(model):
    """The paper's headline: VAMPIRE MAPE << DRAMPower << Micron."""
    m = V.run_validation(model, fleet=psim.make_fleet(SPECS),
                         n_values=N_VALUES).mape_mean
    assert m["vampire"] < 0.5 * m["drampower"]
    assert m["drampower"] < m["micron"]
    assert m["vampire"] < 12.0
    assert m["micron"] > 50.0


@dataclasses.dataclass
class _Scaled:
    """An estimator of the protocol's shape: another model's answers,
    scaled."""
    inner: object
    factor: float
    kind = "scaled"

    @property
    def device(self):
        return self.inner.device

    @property
    def vendors(self):
        return self.inner.vendors

    def estimate(self, traces, vendors=None, **kw):
        rep = self.inner.estimate(traces, vendors, **kw)
        return rep._replace(avg_current_ma=rep.avg_current_ma * self.factor)

    def save(self, path):
        raise NotImplementedError


def test_run_validation_accepts_any_estimator(model):
    fleet = psim.make_fleet(SPECS)
    assert isinstance(_Scaled(model, 1.0), pma.Estimator)
    base = V.run_validation(model, fleet=fleet, n_values=N_VALUES)
    res = V.run_validation(model, fleet=fleet, n_values=N_VALUES,
                           estimators={"same": _Scaled(model, 1.0),
                                       "high": _Scaled(model, 1.5)})
    assert list(res.mape) == ["same", "high"]
    np.testing.assert_allclose(res.mape_mean["same"],
                               base.mape_mean["vampire"], rtol=1e-12)
    assert res.mape_mean["high"] > 40.0
    assert "same" in res.summary() and "MAPE(C)" in res.summary()


def test_surface_sweep_trace_equals_the_reference():
    want, got = RV.surface_sweep_trace(), V.surface_sweep_trace()
    for name, a, b in zip(want._fields, want, got):
        b = b.numpy().view(np.uint32) if name == "data" else b.numpy()
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)


@pytest.mark.parametrize("kind", pma.ESTIMATOR_KINDS)
def test_surface_maps_match_the_reference(quick_vampire, model, kind):
    want = RV.structural_surface_maps(rma.make_estimator(kind,
                                                         quick_vampire))
    est = pma.make_estimator(kind, model)
    for impl in ("vectorized", "cuda"):
        got = V.structural_surface_maps(est, impl=impl)
        assert got.shape == want.shape == (3, 8, 8)
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=impl)
        np.testing.assert_allclose(got.sum(axis=(1, 2)), 1.0, rtol=1e-12)
        if kind != "vampire":
            np.testing.assert_allclose(got, 1 / 64, rtol=RTOL)
    two = V.structural_surface_maps(est, vendors=(2, 0))
    np.testing.assert_allclose(two, want[[2, 0]], rtol=RTOL)


def test_fig14_matches_the_reference(quick_vampire, model):
    """On the model carried across by the v2 file: the same keys in the
    same order, every ratio at rtol 1e-6; the low-power keys sit below
    their datasheet values."""
    want = RV.measured_over_datasheet(quick_vampire)
    got = V.measured_over_datasheet(model)
    assert list(got) == list(want) == [0, 1, 2]
    for v in want:
        assert list(got[v]) == list(want[v])
        np.testing.assert_allclose(list(got[v].values()),
                                   list(want[v].values()), rtol=1e-6)
        for k in ("IDD2P1", "IDD2P0", "IDD3P", "IDD6"):
            assert got[v][k] < 1.0


def test_fig14_needs_the_campaign_arrays(model):
    bare = Vampire(model.fleet, model.idd_keys)
    with pytest.raises(ValueError, match="raw campaign arrays"):
        V.measured_over_datasheet(bare)
    unraw = Vampire(model.fleet, model.idd_keys, dataclasses.replace(
        model.saved, raw=False))
    with pytest.raises(ValueError, match="idd_measured"):
        V.measured_over_datasheet(unraw)


def test_renderers_give_the_reference_text(quick_vampire, reference):
    ratios = RV.measured_over_datasheet(quick_vampire)
    assert V.render_fig14_table(ratios) == RV.render_fig14_table(ratios)
    surf = RV.structural_surface_maps(quick_vampire)
    for v in range(3):
        assert V.render_surface_heatmap(surf[v], f"vendor {v}") == \
            RV.render_surface_heatmap(surf[v], f"vendor {v}")
    assert V.render_surface_heatmap(surf[0]) == \
        RV.render_surface_heatmap(surf[0])
    res = V.ValidationResult(reference.mape, reference.mape_mean,
                             reference.raw)
    assert res.summary() == reference.summary()


def test_validation_runs_on_the_models_device(model):
    res = V.run_validation(model, fleet=psim.make_fleet(SPECS),
                           n_values=(0, 16))
    assert len(res.raw) == 9 * 2
    assert all(np.isfinite(list(r.values())).all() for r in res.raw.values())
    assert model.device == torch.device("cpu")
