"""``chip_smoke.py``'s charge-kernel, line-kernel, flash-attention,
study, HBM and serve phases rehearsed on the CPU at a tiny size: the
same code that runs on the card, with the CUDA event timers and the
device synchronisation stubbed, and the launch counts (which CPU tensors
never raise) read as launched."""
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture()
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "event_ms",
                        lambda fn, iters, flush=None: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "device_kernels",
                        lambda fn: (fn(), ["kernel"])[1])
    real = chip_smoke.read_counters
    monkeypatch.setattr(chip_smoke, "read_counters", lambda: {
        k: max(v, 1) for k, v in real().items()})
    return chip_smoke


@pytest.fixture()
def cpu_model(smoke):
    from repro_torch.core import model_api
    return model_api.load_estimator(str(smoke.MODEL_FILE), device="cpu")


def test_line_kernel_phase_rows(smoke, capsys):
    rows = smoke.line_kernel_phase(0, "cpu", device="cpu", shape=(64, 256))
    assert [r["name"] for r in rows] == ["line_ones", "line_toggles",
                                        "bdi_sizes", "apply_lut_lines"]
    assert all(r["bound"][1] == "bytes" for r in rows)
    assert [r["library_ms"] is None for r in rows] == [True] * 3 + [False]
    assert set(rows[0]) >= {"source", "replaces", "ms", "plain_ms", "err"}
    assert capsys.readouterr().out.count("[kernel]") == 4


def test_line_toggles_row_counts_device_operations(smoke, monkeypatch,
                                                   capsys):
    smoke.line_kernel_phase(0, "cpu", device="cpu", shape=(64, 256))
    out = capsys.readouterr().out
    assert out.count("device_ops=1") == 1
    assert "[kernel] line_toggles: " in out.split("device_ops=1")[0]
    monkeypatch.setattr(smoke, "device_kernels", lambda fn: ["fill", "k"])
    with pytest.raises(smoke.CheckFailed, match="2 device operations"):
        smoke.line_kernel_phase(0, "cpu", device="cpu", shape=(64, 256))


def test_toggles_gib_phase_row(smoke, capsys):
    smoke.toggles_gib_phase(0, "cpu", device="cpu", n_lines=1000)
    (line,) = capsys.readouterr().out.splitlines()
    assert line.startswith("[kernel] line_toggles (1 GiB): ms=1.0000 ")
    ms, by = smoke.bound(1000 * 68, 1000 * 47)
    assert by == "bytes" and f"bound_ms={ms:.4f}" in line
    assert "shape=(lines=1000, 16)" in line


def test_faults_phase_on_cpu_models(smoke, cpu_model, capsys):
    from repro_torch.core import model_api
    models = {k: model_api.make_estimator(k, cpu_model) for k in smoke.KINDS}
    smoke.faults_phase(models, device="cpu")
    out = capsys.readouterr().out
    assert "[faults] 4 out-of-range addresses refused" in out
    assert "in 72 (address, kind, impl, mode) cases" in out


def test_study_and_hbm_phases(smoke, cpu_model, monkeypatch, capsys):
    from repro_torch.core import traces
    monkeypatch.setattr(traces, "SPEC_APPS", traces.SPEC_APPS[6:8])
    launched = smoke.study_phase(0, cpu_model, "cpu", n_requests=200)
    assert set(launched) == set(smoke.counters())
    smoke.hbm_phase(0, cpu_model, "cpu", mib=1, ones_bytes=1 << 16)
    out = capsys.readouterr().out
    assert out.count("[study]") == 3 and "owi_mean_saving" in out
    assert out.count("[hbm]") == 5
    assert "ones_frac=1.0 toggle_frac=0.0" in out


def test_exits_without_a_card(smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert "chip_smoke" in sys.modules


def test_result_lines(smoke, capsys):
    rows = smoke.line_kernel_phase(0, "cpu", device="cpu", shape=(64, 256))
    capsys.readouterr()
    launches = {r["name"]: 3 for r in rows}
    smoke.print_result(rows, launches, "Card X, 700.00 W", "Card X", 1)
    kernels, card, last = capsys.readouterr().out.splitlines()
    assert card == "Card X, 700.00 W"
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "Card X", "count": 1}}
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    entries = json.loads(kernels)["kernels"]
    assert [set(e) for e in entries] == [keys] * 4
    assert all(e["launches"] == 3 and e["route"] == "cuda" for e in entries)


def test_attention_flops_count_the_causal_pairs(smoke):
    assert smoke.attention_flops(2, 4, 4, 8, causal=False) == 4 * 2 * 16 * 8
    # causal, top-left: query i sees keys 0..i -> 1 + 2 + 3 + 4 pairs
    assert smoke.attention_flops(2, 4, 4, 8, causal=True) == 4 * 2 * 10 * 8
    # the serving prefill: 68.75 GFLOP, bound by operations at 0.0695 ms
    ops = smoke.attention_flops(64, 2048, 2048, 128, causal=True)
    assert ops == 4 * 64 * 2048 * 2049 // 2 * 128
    ms, by = smoke.bound(2 * (2 * 64 + 2 * 8) * 2048 * 128, ops,
                         smoke.BF16_OPS_PER_S)
    assert by == "operations" and abs(ms - 0.0695) < 1e-3


def test_flash_kernel_phase_row(smoke, capsys):
    (row,) = smoke.flash_kernel_phase(0, "cpu", device="cpu",
                                      shape=(2, 4, 2, 48, 16), ragged=40,
                                      wide=(1, 7, 1, 40, 16))
    assert row["name"] == "flash_attention" and row["err"] == 0.0
    assert row["source"] == "src/repro_torch/csrc/flash_attention.cu"
    assert row["replaces"].endswith("flash_attention.py:73")
    assert row["library_ms"] == 1.0
    out = capsys.readouterr().out
    assert out.count("[kernel] flash_attention") == 1
    assert "ragged_err=0.000e+00" in out and "f32_err=0.000e+00" in out
    assert "group7_err=0.000e+00 (BH=7, BH_kv=1, S=40)" in out
    flops = smoke.attention_flops(8, 48, 48, 16, True)
    assert f"tflops={flops / 1.0 / 1e9:.1f}" in out      # stubbed 1 ms


def test_charge_kernel_rows_and_the_one_kernel_check(smoke, cpu_model,
                                                    monkeypatch, capsys):
    """The charge kernels' rows on a small batch: each checked against its
    plain version and timed with its GB/s; the profiler check passes a
    call that runs one device operation and fails one that runs two."""
    from repro_torch.core import model_api
    _, tb = smoke.build_workload(0, 3, 150, 2048, "cpu")
    models = {k: model_api.make_estimator(k, cpu_model) for k in smoke.KINDS}
    rows = smoke.kernel_phase(tb, models, "cpu")
    names = [r["name"] for r in rows]
    assert names == ["batched_features", "vampire_charge",
                     "vampire_charge_surface", "micron_charge",
                     "micron_charge_surface", "drampower_charge",
                     "drampower_charge_surface"]
    assert all(r["bound"][1] == "bytes" for r in rows)
    out = capsys.readouterr().out
    assert out.count("[kernel]") == 7 and out.count("gb_per_s=") == 6
    monkeypatch.setattr(smoke, "device_kernels", lambda fn: ["kernel"])
    smoke.one_kernel_phase(rows)
    assert capsys.readouterr().out.count("one device operation") == 6
    monkeypatch.setattr(smoke, "device_kernels",
                        lambda fn: ["kernel", "reduce"])
    with pytest.raises(smoke.CheckFailed, match="2 device operations"):
        smoke.one_kernel_phase(rows)


def test_vocab_bar_ignores_the_padded_vocabulary(smoke):
    a = torch.zeros(2, 8)
    b = torch.zeros(2, 8)
    b[:, 6:] = -1e30
    err, bar = smoke.vocab_bar(a, b, vocab=6)
    assert err == 0.0 and bar == pytest.approx(0.05, abs=1e-5)


def test_serve_phase_at_smoke_size(smoke, monkeypatch, capsys):
    real = smoke.read_counters
    monkeypatch.setattr(smoke, "read_counters", lambda: {
        k: (2 if k == "flash_attention" else max(v, 1))
        for k, v in real().items()})
    launched = smoke.serve_phase(0, "cpu", device="cpu", smoke=True,
                                 batch=2, prompt_len=40, decode_tokens=4)
    assert launched["flash_attention"] == 2       # one per layer
    out = capsys.readouterr().out
    assert out.count("[serve]") == 6
    assert "flash_launches_per_prefill=2" in out
    assert "power[vampire] impl=cuda" in out and "teacher_forcing_err" in out


def test_campaign_phase_at_quick_size(smoke, capsys):
    """The ``[campaign]`` phase on the tiny fleet at the quick plan: the
    ``'cuda'`` fit (the kernels' plain versions here) against
    ``'vectorized'``, the recoveries, the committed quick fit, save and
    load."""
    from repro_torch.core import params
    specs = [params.ModuleSpec(v, i, 2015) for v in range(3)
             for i in range(3)]
    launched = smoke.campaign_phase("cpu", device="cpu", specs=specs,
                                    **smoke.QUICK_FIT)
    assert launched["batched_features"] and launched["vampire_charge"]
    out = capsys.readouterr().out
    assert "[campaign] fleet: modules=9 (A 3, B 3, C 3)" in out
    assert out.count("[campaign] table5") == 12
    assert out.count("[campaign] surface vendor=") == 3
    assert "matches the committed vampire_quickfit_v2.npz" in out
    assert out.count("[kernel] ") == 3 and "save and load" in out


def test_fleet_phase_at_a_small_size(smoke, capsys):
    launched = smoke.fleet_phase("cpu", device="cpu", sizes=(20, 45),
                                 module_chunk=8, probe_reps=64, n_rows=8)
    assert launched["vampire_charge_surface"] and launched["vampire_charge"]
    out = capsys.readouterr().out
    assert "[fleet] surface map: modules=45 traces=2 commands=144" in out
    assert "chunked_equals_one_shot_at_20=True" in out
    assert "[fleet] probes: modules=45 probes=348 commands=262" in out
    assert "matrix=(45, 348)" in out and out.count("[kernel] ") == 6


def test_fit_close_holds_the_reference_bar(smoke):
    assert smoke.fit_close([1.0, 2e-7], [1.00009, 1e-6], "x") < 1.0
    with pytest.raises(smoke.CheckFailed, match="share of the bar"):
        smoke.fit_close([1.0], [1.0002], "x")
    with pytest.raises(smoke.CheckFailed, match="shape"):
        smoke.fit_close([1.0], [1.0, 2.0], "x")


QUICK_SPECS = [(v, i, 2015) for v in range(3) for i in range(3)]


@pytest.fixture()
def one_torch_thread():
    """Several workers share the machine's cores; the phases' many small
    tensor operations run faster on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quick_specs():
    from repro_torch.core import params
    return [params.ModuleSpec(*s) for s in QUICK_SPECS]


@pytest.mark.usefixtures("one_torch_thread")
def test_validation_phase_at_quick_size(smoke, capsys):
    """``[validation]`` on the tiny fleet at the quick plan and a cut
    sweep: the ``'cuda'`` run (plain versions here) against
    ``'vectorized'``, the MAPEs and the paper's ordering, Fig 14, the
    surface maps of the three kinds and the kernel rows at its shapes."""
    launched, model = smoke.validation_phase(
        "cpu", device="cpu", specs=_quick_specs(), n_values=(0, 8, 64, 764),
        **smoke.QUICK_FIT)
    assert set(launched) == set(smoke.counters())
    assert model.vendors == (0, 1, 2)
    out = capsys.readouterr().out
    assert "[validation] fleet=9 held_out=9 (A 3, B 3, C 3) sweeps=4" in out
    assert "measured=(9 x 4) grids=(4 x 3) x 3" in out
    assert out.count("[validation] mape ") == 3 and "paper=6.8%" in out
    assert out.count("[validation] fig14 ") == 13     # header + 12 keys
    assert out.count("[validation] surface ") == 3
    assert out.count("sums_to_1=True") == 3
    assert out.count("[kernel] ") == 6 + 3
    assert "(validation, 4 sweeps)" in out
    assert "(validation probes, 9 modules)" in out


@pytest.mark.usefixtures("one_torch_thread")
def test_apps_phase_at_a_small_size(smoke, cpu_model, monkeypatch, capsys):
    from repro_torch.core import traces
    monkeypatch.setattr(traces, "SPEC_APPS",
                        [traces.SPEC_APPS[3], traces.SPEC_APPS[21]])
    launched = smoke.apps_phase(cpu_model, "cpu", n_requests=300)
    assert set(launched) == set(smoke.counters())
    out = capsys.readouterr().out
    assert "[apps] apps=2 n_requests=300" in out
    assert "estimate_calls=4" in out and "powerdown_rewrites=6" in out
    assert "remaps=2 (commands and data kept" in out
    assert "lint_errors=0" in out and "host_s=" in out
    assert out.count("[apps] powerdown (vendor A)") == 3
    assert "[apps] page allocation (vendor C): mean_saving=" in out


@pytest.mark.usefixtures("one_torch_thread")
def test_recal_phase_at_quick_size(smoke, capsys):
    """``[recal]`` on the tiny fleet at the quick plan, 10 ticks: the
    tick loop through ``'cuda'`` (plain versions here), the frozen and
    recalibrated errors, the oracle, and the service's hot swap."""
    launched = smoke.recal_phase("cpu", device="cpu", specs=_quick_specs(),
                                 checkpoints=(5, 10), probe_reps=64,
                                 n_rows=8, probe_modules=2)
    assert set(launched) == set(smoke.counters())
    out = capsys.readouterr().out
    assert "[recal] fleet=9 cells=360 (IDD 12 + probes 348) slice=120" in out
    assert "checkpoints=[5, 10]" in out and "oracle_mape=" in out
    assert "(reference test asks >= 5)" in out
    assert "triggers=" in out and "campaign_refit_s=" in out
    assert "recalibrations=1 engine_programs=" in out
    assert "answers_changed=True" in out
    assert "(recal slice, 120 probe cells)" in out
    assert "(recal IDD cells, 12)" in out and out.count("[kernel] ") == 6


def test_analysis_phase(smoke, cpu_model, capsys):
    from repro_torch.analysis import dispatch_audit as da
    smoke.analysis_phase(da.default_audit_batch("cpu"), cpu_model, "cpu",
                         device="cpu")
    out = capsys.readouterr().out
    assert "[analysis] trace lint: 51 traces, 0 errors, 0 warnings" in out
    assert "[analysis] dispatch audit: 0 errors, 0 warnings" in out
    assert "[analysis] repo lint: 0 errors, 0 warnings" in out
    assert out.count("combinations, errors=0") == 2


def test_autotune_phase(smoke, monkeypatch, capsys):
    from repro_torch.kernels import autotune
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    shapes = {"estimation": (3, 700, 3), "validation": (2, 300, 3),
              "slice": (4, 200, 5)}
    monkeypatch.setattr(autotune, "MAIN_PATH_SHAPES", shapes)
    v3 = (shapes["estimation"], shapes["validation"])
    monkeypatch.setattr(autotune, "FAMILY_SHAPES", {
        "vampire_energy": tuple(shapes.values()),
        "vampire_energy_surface": v3, "baseline_energy": v3,
        "baseline_energy_surface": v3})
    smoke.autotune_phase("cpu", device="cpu")
    out = capsys.readouterr().out
    assert out.count("[autotune] vampire_energy ") == 3
    assert out.count("[autotune] vampire_energy_surface ") == 2
    assert out.count("[autotune] baseline_energy ") == 2
    assert out.count("[autotune] baseline_energy_surface ") == 2
    assert "[autotune] sweep vampire_energy t2n512 V=3: 12 candidates" in out
