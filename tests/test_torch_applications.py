"""The port's Section 9.3 applications (``repro_torch.core.applications``)
against the reference's: the tests of ``tests/test_applications.py`` on
the port, then parity on seeded inputs — ``cheap_rows``,
``rank_banks_for_reads`` and ``remap_trace`` equal exactly, the idle-state
choice over a gap sweep, ``apply_powerdown_policy`` field by field (and
lint clean), and both studies at rtol 1e-5 through ``'vectorized'`` and
``'cuda'`` (the kernels' plain versions on the CPU).  The reference's
quick fit comes across through its schema-v2 file."""
import numpy as np
import pytest
import torch

from repro.core import applications as RA
from repro.core import model_api as rma
from repro.core import traces as rtraces
from repro_torch.analysis import trace_lint
from repro_torch.core import applications as A
from repro_torch.core import dram, model_api as pma, traces

RTOL = 1e-5


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
    path = tmp_path_factory.mktemp("apps") / "quick.npz"
    rma.save_estimator(quick_vampire, str(path))
    return pma.load_estimator(str(path), device="cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_trace_equal(port, ref, what=""):
    for name, a, b in zip(ref._fields, ref, port):
        b = _np(b)
        if name == "data":
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, np.asarray(a),
                                      err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# The reference's tests, on the port
# ---------------------------------------------------------------------------
def test_breakeven_positive_and_sane(model):
    bes = {v: A.breakeven_idle_cycles(model.params(v))
           for v in model.vendors}
    for v, be in bes.items():
        assert 10 < be < 500, (v, be)
    assert bes[0] == max(bes.values())


def test_powerdown_policy_inserts_valid_commands():
    tr = traces.app_trace(traces.SPEC_APPS[21], n_requests=200)  # povray
    ptr = A.apply_powerdown_policy(tr, timeout_cycles=64)
    cmd = _np(ptr.cmd)
    pde_idx = np.flatnonzero(cmd == dram.PDE)
    assert len(pde_idx) > 0
    for i in pde_idx:
        assert cmd[i - 1] == dram.PREA
        after = cmd[i + 1:]
        nxt = after[np.isin(after, (dram.PDX, dram.PDE))]
        assert len(nxt) == 0 or nxt[0] == dram.PDX
    for op in (dram.RD, dram.WR):
        assert (_np(tr.cmd) == op).sum() == (cmd == op).sum()


def test_powerdown_saves_on_idle_app(model):
    res = A.powerdown_study(model, traces.SPEC_APPS[21], vendor=0,
                            n_requests=300)
    assert res["breakeven_saving"] > 0
    assert res["lazy_saving"] <= res["breakeven_saving"] + 0.02


def test_page_remap_preserves_workload(model):
    tr = traces.app_trace(traces.SPEC_APPS[3], n_requests=200)
    remapped = A.remap_trace(tr, model.params(2))
    assert torch.equal(tr.cmd, remapped.cmd)
    assert torch.equal(tr.data, remapped.data)
    assert not torch.equal(tr.bank, remapped.bank)
    assert remapped.bank.dtype == remapped.row.dtype == torch.int32
    assert remapped.bank.device == tr.device


def test_page_allocation_saves_on_vendor_c(model):
    res = A.page_allocation_study(model, traces.SPEC_APPS[3], vendor=2,
                                  n_requests=400)
    assert res["saving_frac"] > 0.0


def test_cheap_rows_low_popcount():
    rows = A.cheap_rows(16)
    assert max(bin(int(r)).count("1") for r in rows) <= 2


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 16, 300, 5000])
def test_cheap_rows_equal_the_reference(n):
    np.testing.assert_array_equal(A.cheap_rows(n), RA.cheap_rows(n))


def test_bank_ranking_equals_the_reference(quick_vampire, model):
    for v in model.vendors:
        np.testing.assert_array_equal(
            A.rank_banks_for_reads(model.params(v)),
            RA.rank_banks_for_reads(quick_vampire.params(v)))


@pytest.mark.parametrize("app,vendor,hot", [(3, 2, 0.25), (7, 0, 0.5),
                                            (13, 1, 0.1)])
def test_remap_trace_equals_the_reference(quick_vampire, model, app, vendor,
                                          hot):
    rtr = rtraces.app_trace(rtraces.SPEC_APPS[app], n_requests=300)
    ptr = traces.app_trace(traces.SPEC_APPS[app], n_requests=300)
    want = RA.remap_trace(rtr, quick_vampire.params(vendor), hot_frac=hot)
    got = A.remap_trace(ptr, model.params(vendor), hot_frac=hot)
    _assert_trace_equal(got, want, f"app {app}")


def test_idle_state_choice_equals_the_reference(quick_vampire, model):
    assert A.IDLE_EXIT_HEADROOM == RA.IDLE_EXIT_HEADROOM
    assert A._ENTRY_CMDS == RA._ENTRY_CMDS
    for gap in [0, 1, 7, 63, 64, 100, 200, 255, 256, 511, 512, 1000,
                1023, 1024, 1500, 2047, 2048, 5000, 100_000]:
        assert A.select_idle_state(gap) == RA.select_idle_state(gap), gap
    for v in model.vendors:
        assert A.breakeven_idle_cycles(model.params(v)) == \
            RA.breakeven_idle_cycles(quick_vampire.params(v))


@pytest.mark.parametrize("app,timeout", [(21, 64), (21, 20), (3, 200),
                                         (7, 40), (16, 1000)])
def test_powerdown_policy_equals_the_reference(app, timeout):
    """Field by field, the re-placed refreshes included, and lint clean."""
    rtr = rtraces.app_trace(rtraces.SPEC_APPS[app], n_requests=250)
    ptr = traces.app_trace(traces.SPEC_APPS[app], n_requests=250)
    want = RA.apply_powerdown_policy(rtr, timeout)
    got = A.apply_powerdown_policy(ptr, timeout)
    _assert_trace_equal(got, want, f"app {app} timeout {timeout}")
    assert not trace_lint.errors_of(trace_lint.lint_trace(got))


@pytest.mark.parametrize("impl", ["vectorized", "cuda"])
@pytest.mark.parametrize("app,vendor", [(3, 2), (21, 0), (9, 1)])
def test_studies_match_the_reference(quick_vampire, model, impl, app,
                                     vendor):
    rapp, papp = rtraces.SPEC_APPS[app], traces.SPEC_APPS[app]
    want = RA.page_allocation_study(quick_vampire, rapp, vendor,
                                    n_requests=300)
    got = A.page_allocation_study(model, papp, vendor, n_requests=300,
                                  impl=impl)
    assert (got["app"], got["vendor"]) == (want["app"], want["vendor"])
    for key in ("baseline_pj", "remapped_pj"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)
    np.testing.assert_allclose(got["saving_frac"], want["saving_frac"],
                               rtol=1e-3, atol=1e-6)

    want = RA.powerdown_study(quick_vampire, rapp, vendor, n_requests=300)
    got = A.powerdown_study(model, papp, vendor, n_requests=300, impl=impl)
    assert got["breakeven_cycles"] == want["breakeven_cycles"]
    for name in ("aggressive", "breakeven", "lazy"):
        assert got[f"{name}_modes"] == want[f"{name}_modes"]
        np.testing.assert_allclose(got[f"{name}_pj"], want[f"{name}_pj"],
                                   rtol=RTOL)
    np.testing.assert_allclose(got["baseline_pj"], want["baseline_pj"],
                               rtol=RTOL)
