"""The port's analysis gate (``repro_torch.analysis``) on the CPU: the
dispatch audit clean over 3 kinds x 3 impls x 4 modes and each of its
checks firing on a planted fault; every repo-lint rule firing on a seeded
snippet and the live tree clean; the CLI's corpus against the reference's
(labels and lint diagnostics); and the repairs of F4 (``estimate`` reads
no vendor ids from the card) and F5 (no float64 buffer in a surface
dispatch, surface parity kept)."""
import ast
import dataclasses
import itertools
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import __main__ as ref_cli
from repro.analysis import repo_lint as ref_repo_lint
from repro.analysis import trace_lint as ref_trace_lint
from repro.core import model_api as rma
from repro.core import traces as rtraces
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import dispatch_audit as da
from repro_torch.analysis import repo_lint
from repro_torch.core import dram as pdram
from repro_torch.core import estimate_batch as pbatch
from repro_torch.core import model_api as pma
from repro_torch.core.vampire import Vampire
from repro_torch.kernels import common

RTOL = 1e-5
MODEL = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "data" / "vampire_quickfit_v2.npz")
MODES = ("mean", "range", "distribution", "surface")
IMPLS = ("vectorized", "reference", "cuda")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vampire():
    return pma.load_estimator(str(MODEL), device="cpu")


@pytest.fixture(scope="module")
def tb():
    return da.default_audit_batch("cpu")


class Wrapped:
    """An estimator whose ``estimate`` is the real one passed through
    ``hook(model, batch, kwargs) -> report`` (the planted faults)."""

    def __init__(self, model, hook):
        self.model, self.hook = model, hook
        self.kind, self.vendors = model.kind, model.vendors

    def estimate(self, traces, vendors=None, **kw):
        return self.hook(self.model, traces, vendors, kw)


# ---------------------------------------------------------------------------
# Dispatch audit: clean on the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", pma.ESTIMATOR_KINDS)
def test_dispatch_audit_clean_over_every_impl_and_mode(vampire, tb, kind):
    model = pma.make_estimator(kind, vampire)
    findings = da.audit_model(model, tb=tb, device="cpu")
    assert findings == []
    assert set(pma.registered_impls()) == set(IMPLS)


def test_dispatch_audit_batch_is_the_references(tb):
    from repro.analysis import dispatch_audit as ref_da
    ref = ref_da.default_audit_batch()
    assert tb.trace.cmd.shape == ref.trace.cmd.shape
    np.testing.assert_array_equal(tb.weight.numpy(), np.asarray(ref.weight))
    for got, want in zip(tb.trace, ref.trace):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(want).view(np.int32)
            if np.asarray(want).dtype == np.uint32 else np.asarray(want))
    assert bool((tb.weight == 0).any())        # real pad slots


def test_serving_recompile_probe_holds(vampire):
    assert da.audit_serving(vampire, device="cpu") == []
    assert da.audit_serving(vampire, impl="cuda", device="cpu") == []


def test_audit_fleet_chunked_clean():
    assert da.audit_fleet_chunked(device="cpu") == []


def test_audit_recalibration_clean(vampire):
    assert da.audit_recalibration(vampire, device="cpu") == []


# ---------------------------------------------------------------------------
# Dispatch audit: each check fires on a planted fault
# ---------------------------------------------------------------------------
def test_recorder_sees_wide_outputs_and_host_round_trips():
    x = torch.arange(6, dtype=torch.float32)
    _, rec, sync = da.record(lambda: (x.to(torch.float64), x.sum().item(),
                                      x[x > 2], torch.tensor([1.0])), "cpu")
    assert sync is None
    assert [op for op, _ in rec.wide] == ["aten._to_copy.default"]
    assert rec.wide[0][1] == (6,)
    names = " ".join(rec.host)
    assert "_local_scalar_dense" in names and "nonzero" in names
    assert "lift_fresh" in names
    _, clean, _ = da.record(lambda: (x * 2.0).sum(-1), "cpu")
    assert clean.wide == [] and clean.host == []


@pytest.mark.parametrize("impl", IMPLS)
def test_audit_flags_a_dispatch_that_widens_to_float64(vampire, tb, impl):
    def widen(model, traces, vendors, kw):
        rep = model.estimate(traces, vendors, **kw)
        return type(rep)(*(x.to(torch.float64) for x in rep))
    findings = da.audit_combination(Wrapped(vampire, widen), impl, "mean",
                                    tb, "cpu")
    assert [f.check for f in findings] == ["float64"]
    assert "aten._to_copy" in findings[0].detail


@pytest.mark.parametrize("impl", IMPLS)
def test_audit_flags_an_item_in_the_dispatch(vampire, tb, impl):
    def item(model, traces, vendors, kw):
        if float(traces.weight.sum()) < 0:     # a host round trip
            raise AssertionError
        return model.estimate(traces, vendors, **kw)
    findings = da.audit_combination(Wrapped(vampire, item), impl, "mean",
                                    tb, "cpu")
    if impl == "reference":                  # a host walk by design
        assert findings == []
    else:
        assert [f.check for f in findings] == ["host_callback"]
        assert "_local_scalar_dense" in findings[0].detail


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("impl", ("vectorized", "cuda"))
def test_audit_flags_a_dispatch_that_ignores_weight(vampire, tb, impl, mode):
    """The port's twin of the reference's dead-weight test: a dispatch
    that scores every slot as real is caught by both perturbations."""
    def unmasked(model, traces, vendors, kw):
        ones = pbatch.TraceBatch(traces.trace, torch.ones_like(traces.weight))
        return model.estimate(ones, vendors, **kw)
    findings = da.audit_combination(Wrapped(vampire, unmasked), impl, mode,
                                    tb, "cpu")
    assert [f.check for f in findings] == ["pad_masking", "pad_masking"]


def test_perturbations_keep_shapes_and_pads(tb):
    dropped, filled = da._perturbed(tb)
    assert int((tb.weight - dropped.weight).sum()) == 1
    assert torch.equal(filled.weight, tb.weight)
    pad = tb.weight == 0
    assert bool((filled.trace.dt[pad] > 0).any())     # live commands
    assert torch.equal(filled.trace.cmd[~pad], tb.trace.cmd[~pad])


def test_audit_flags_planted_geometry_growth(vampire, tb):
    counter = itertools.count(1 << 20)

    def growing(model, traces, vendors, kw):
        common.charge_geometry(next(counter), 1, 1, 1)
        return model.estimate(traces, vendors, **kw)
    findings = da.audit_recompilation(Wrapped(vampire, growing),
                                      modes=("mean",), tb=tb, device="cpu",
                                      impls=("vectorized",))
    assert {f.check for f in findings} == {"recompile"}
    # the repeat, the re-pad, the first subset (3 entries past the warm
    # state, against at most one) and the equal-size subset
    assert len(findings) == 4
    assert da.audit_recompilation(vampire, modes=("mean",), tb=tb,
                                  device="cpu") == []


def test_audit_reports_a_dispatch_that_fails(vampire, tb):
    def broken(model, traces, vendors, kw):
        if getattr(broken, "warm", False):
            raise ValueError("boom")
        broken.warm = True
        return model.estimate(traces, vendors, **kw)
    (f,) = da.audit_combination(Wrapped(vampire, broken), "vectorized",
                                "mean", tb, "cpu")
    assert f.check == "audit_trace" and "boom" in f.detail


# ---------------------------------------------------------------------------
# F4: estimate reads no vendor ids from the model's tensors
# ---------------------------------------------------------------------------
class _Unread(torch.Tensor):
    """A tensor that raises on any read."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"fleet.vendor_ids read by {func}")

    def tolist(self):
        raise AssertionError("fleet.vendor_ids read by tolist")


def test_estimate_reads_no_vendor_ids(vampire, tb):
    ids = vampire.fleet.vendor_ids.as_subclass(_Unread)
    model = dataclasses.replace(vampire,
                                fleet=vampire.fleet._replace(vendor_ids=ids))
    assert model.vendors == (0, 1, 2)
    for kind in pma.ESTIMATOR_KINDS:
        est = pma.make_estimator(kind, model)
        for impl, mode in itertools.product(IMPLS, MODES):
            est.estimate(tb, mode=mode, impl=impl, **da._MODE_KW.get(mode, {}))
            est.estimate(tb, [2, 0], mode=mode, impl=impl,
                         **da._MODE_KW.get(mode, {}))
    assert model.params(1) is not None and set(model.datasheets()) == {0, 1, 2}


def test_vendor_order_is_fixed_when_the_model_is_built(vampire, tmp_path):
    assert vampire.vendor_order == (0, 1, 2)
    assert vampire.to("cpu").vendor_order == (0, 1, 2)
    path = tmp_path / "m.npz"
    vampire.save(str(path))
    assert Vampire.load(str(path), device="cpu").vendor_order == (0, 1, 2)
    built = Vampire(vampire.fleet, vampire.idd_keys, vendor_order=[0, 1, 2])
    assert built.vendors == (0, 1, 2) and isinstance(built.vendors, tuple)
    from repro_torch.core import params as P
    from repro_torch.core import recalibrate
    fitter = recalibrate.StreamingFitter(
        vampire, [P.ModuleSpec(v, 0, 2015) for v in range(3)],
        recalibrate.RecalConfig(probe_reps=64, n_rows=8, probe_modules=1,
                                slice_size=16))
    assert fitter.refit().vendor_order == (0, 1, 2)


# ---------------------------------------------------------------------------
# F5: float32 surfaces, parity kept
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", pma.ESTIMATOR_KINDS)
@pytest.mark.parametrize("impl", IMPLS)
def test_no_float64_op_in_any_surface_dispatch(vampire, tb, kind, impl):
    model = pma.make_estimator(kind, vampire)
    _, rec, _ = da.record(
        lambda: model.estimate(tb, mode="surface", impl=impl), "cpu")
    assert rec.wide == []


def test_cell_sums_match_a_float64_scatter():
    gen = torch.Generator().manual_seed(3)
    values = torch.rand((3, 5, 16384 + 77), generator=gen) * 400.0
    cells = torch.randint(0, 4, (5, 16384 + 77), generator=gen)
    got = common.cell_sums(values, cells, 64)
    want = torch.zeros((3, 5, 64), dtype=torch.float64).scatter_add_(
        -1, cells.expand(values.shape), values.double())
    assert got.dtype == torch.float32 and got.shape == (3, 5, 64)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=1e-6)
    ints = torch.randint(0, 900, (5, 1000), generator=gen, dtype=torch.int32)
    exact = common.cell_sums(ints, cells[:, :1000], 64)
    assert exact.dtype == torch.int32
    assert torch.equal(exact.long(), torch.zeros((5, 64), dtype=torch.long)
                       .scatter_add_(-1, cells[:, :1000], ints.long()))
    assert torch.equal(common.cell_sums(values[..., :0], cells[:, :0], 64),
                       torch.zeros((3, 5, 64)))


@pytest.mark.parametrize("kind", pma.ESTIMATOR_KINDS)
def test_long_surfaces_keep_parity_with_the_reference(vampire, kind):
    """Traces of many 128-command blocks: every port impl's surface
    against the reference's ``'vectorized'`` at rtol 1e-5, summing to the
    port's mean at rtol 1e-5, the cycles exact."""
    apps = [rtraces.app_trace(rtraces.SPEC_APPS[i], n_requests=n)
            for i, n in ((2, 1500), (9, 900))]
    ref_model = rma.make_estimator(kind, rma.load_estimator(str(MODEL)))
    want = ref_model.estimate(apps, mode="surface", impl="vectorized")
    port_trs = [pdram.make_trace(*[np.asarray(f) for f in tr])
                for tr in apps]
    model = pma.make_estimator(kind, vampire)
    mean = model.estimate(port_trs, mode="mean")
    for impl in IMPLS:
        got = model.estimate(port_trs, mode="surface", impl=impl)
        for name, g, w in zip(got._fields, got, want):
            np.testing.assert_allclose(g.double().numpy(),
                                       np.asarray(w, np.float64), rtol=RTOL,
                                       atol=1e-3, err_msg=f"{impl} {name}")
        np.testing.assert_array_equal(got.cycles.numpy(),
                                      np.asarray(want.cycles))
        np.testing.assert_allclose(
            got.charge_ma_cycles.sum((-2, -1)).double().numpy(),
            mean.charge_ma_cycles.double().numpy(), rtol=RTOL)


# ---------------------------------------------------------------------------
# Repo lint
# ---------------------------------------------------------------------------
def _src(code, rel="core/sample.py"):
    return [(rel, ast.parse(textwrap.dedent(code)))]


def test_repo_lint_clean_on_live_tree():
    assert repo_lint.errors_of(repo_lint.run_repo_lint()) == []


def test_repo_lint_flags_deprecated_shims():
    (f,) = repo_lint.check_no_deprecated_shims(
        _src("model.estimate_range_many(traces)"))
    assert f.rule == "no-deprecated-shims" and "estimate_range_many" \
        in f.message
    # core/vampire.py is not exempt: the port defines no shim
    (f,) = repo_lint.check_no_deprecated_shims(
        _src("def estimate_many(self, t):\n    pass\n", "core/vampire.py"))
    assert "definition" in f.message
    assert repo_lint.check_no_deprecated_shims(
        _src("self.estimate_many(t)", "analysis/repo_lint.py")) == []


def test_repo_lint_flags_modeless_impl():
    (f,) = repo_lint.check_impls_declare_modes(
        _src("register_impl(EstimateImpl(name='x', description='d'))"))
    assert f.rule == "impls-declare-modes"
    assert repo_lint.check_impls_declare_modes(
        _src("register_impl(EstimateImpl(name='x', modes=('mean',)))")) == []


def test_repo_lint_flags_fitter_without_streaming():
    (f,) = repo_lint.check_fitters_declare_streaming(
        _src("register_fitter(FitterSpec(name='x', description='d'))"))
    assert f.rule == "fitters-declare-streaming"
    assert repo_lint.check_fitters_declare_streaming(
        _src("register_fitter(FitterSpec(name='x', streaming=False))")) == []


def test_repo_lint_flags_module_level_interpret():
    (f,) = repo_lint.check_call_time_interpret(
        _src("INTERPRET = True", "kernels/k.py"))
    assert f.rule == "call-time-interpret" and "INTERPRET" in f.message


def test_repo_lint_flags_a_library_user_without_the_per_call_choice():
    msgs = [f.message for f in repo_lint.check_call_time_interpret(_src(
        "def k(x):\n    lib = build.library('k')\n    lib.repro_k(x)\n",
        "kernels/k.py"))]
    assert len(msgs) == 2
    assert "on_cpu" in msgs[0] and "build.check" in msgs[1]
    assert repo_lint.check_call_time_interpret(_src(
        "def k(x):\n    if on_cpu(x):\n        return k_plain(x)\n"
        "    rc = build.library('k').repro_k(x)\n    build.check(rc, 'k')\n",
        "kernels/k.py")) == []


def test_repo_lint_flags_a_fallback_to_the_plain_version():
    code = """
        def k(x):
            if on_cpu(x):
                return k_plain(x)
            try:
                rc = build.library('k').repro_k(x)
                build.check(rc, 'k')
            except RuntimeError:
                return k_plain(x)
    """
    (f,) = repo_lint.check_call_time_interpret(_src(code, "kernels/k.py"))
    assert "falls back" in f.message
    assert repo_lint.check_call_time_interpret(_src(
        code.replace("return k_plain(x)\n", "raise\n", 1)
        .replace("            except RuntimeError:\n"
                 "                return k_plain(x)",
                 "            except RuntimeError:\n"
                 "                raise"), "kernels/k.py")) == []


def test_repo_lint_params_coverage_negative(tmp_path):
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "energy_model.py").write_text(textwrap.dedent("""
        class PowerParams(NamedTuple):
            a: int
            b: int
            orphan: int
            late: int
    """))
    (tmp_path / "core" / "model_api.py").write_text(
        '_FITTED_FIELDS = ("a", "late")\n')
    (tmp_path / "core" / "characterize.py").write_text(textwrap.dedent("""
        def build_params(x):
            return PowerParams(b=x)
    """))
    findings = repo_lint.check_params_serialization(tmp_path,
                                                    v1_keys={"a", "k1"})
    msgs = " | ".join(f.message for f in findings)
    assert len(findings) == 2
    assert "orphan" in msgs          # neither fitted nor derived
    assert "late" in msgs            # fitted, post-v1, no default


def test_repo_lint_params_coverage_live():
    assert repo_lint.check_params_serialization() == []


def test_v1_keys_equal_the_references():
    tree = ref_repo_lint._parse(ref_repo_lint._repo_src() / "core"
                                / "model_api.py")
    assert set(repo_lint.V1_KEYS) == ref_repo_lint._v1_anchor_fields(tree)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
def test_cli_corpus_and_diagnostics_equal_the_references():
    ref = ref_cli._corpus()
    port = cli._corpus("cpu")
    assert [label for label, _ in port] == [label for label, _ in ref]
    assert len(port) == 51
    for (label, rt), (_, pt) in zip(ref, port):
        assert int(pt.n) == int(rt.n), label
        np.testing.assert_array_equal(pt.cmd.numpy(), np.asarray(rt.cmd),
                                      err_msg=label)
        np.testing.assert_array_equal(pt.dt.numpy(), np.asarray(rt.dt),
                                      err_msg=label)
    from repro_torch.analysis import trace_lint
    got = [(d.rule, d.severity, d.trace_index, d.cmd_index, d.bank, d.margin)
           for d in trace_lint.lint_traces([tr for _, tr in port])]
    want = [(d.rule, d.severity, d.trace_index, d.cmd_index, d.bank,
             d.margin)
            for i, (_, tr) in enumerate(ref)
            for d in ref_trace_lint.lint_trace(tr, trace_index=i)]
    assert sorted(got) == sorted(want)


def test_cli_main_is_clean_on_the_cpu(capsys):
    assert cli.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "trace lint: 51 traces, 0 errors, 0 warnings" in out
    assert "dispatch audit: 0 errors, 0 warnings" in out
    assert "repo lint: 0 errors, 0 warnings" in out
    assert out.strip().endswith("analysis clean")


def test_cli_skip_dispatch_and_the_device_rule(capsys):
    assert cli.main(["--skip-dispatch", "--device", "cpu"]) == 0
    assert "dispatch audit: skipped" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--skip-dispatch"])
