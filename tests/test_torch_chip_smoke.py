"""``chip_smoke.py``'s charge-kernel, line-kernel, flash-attention (also
at MLA's widths, and its backward), study, HBM, serve, serve-mla, F7 and
train phases rehearsed on the CPU at a tiny size: the
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


@pytest.mark.parametrize("sq,skv,d,dv", [
    (7, 7, 16, 16), (2048, 2048, 128, 128), (10, 4, 192, 128),
    (3, 10, 64, 64), (1, 1601, 128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_the_flash_modules_count_is_the_yardsticks(smoke, sq, skv, d, dv,
                                                   causal):
    """The flash wrappers' flop formula (the dry run's attention term)
    equals chip_smoke's own closed form, which the kernel rows' bounds
    and ``train_work`` use."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    assert fa.attention_flops(6, sq, skv, d, dv, causal) \
        == smoke.attention_flops(6, sq, skv, d, causal, dv=dv)


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


def test_attention_flops_and_bound_at_the_mla_prefill(smoke):
    """deepseek-v2-lite-16b's prefill attention: B*H*S^2*(D+Dv) = 85.9
    GFLOP, bound by operations at 0.0869 ms; q, k, v and out 167.8 MB."""
    bh, s, d, dv = 64, 2048, 192, 128
    ops = smoke.attention_flops(bh, s, s, d, True, dv=dv)
    assert ops == 2 * bh * (s * (s + 1) // 2) * (d + dv)
    assert abs(ops / 1e9 - 85.9) < 0.1
    nbytes = 2 * bh * s * (2 * d + 2 * dv)
    assert abs(nbytes / 1e6 - 167.8) < 0.1
    ms, by = smoke.bound(nbytes, ops, smoke.BF16_OPS_PER_S)
    assert by == "operations" and abs(ms - 0.0869) < 1e-4


def test_flash_mla_kernel_phase_row(smoke, capsys):
    (row,) = smoke.flash_mla_kernel_phase(0, "cpu", device="cpu",
                                          shape=(1, 2, 40, 48, 32),
                                          ragged=33)
    assert row["name"] == "flash_attention_mla" and row["err"] == 0.0
    assert row["source"] == "src/repro_torch/csrc/flash_attention.cu"
    assert row["replaces"].endswith("flash_attention.py:73")
    assert row["library_ms"] == 1.0 and row["fn"]().shape == (2, 40, 32)
    out = capsys.readouterr().out
    assert out.count("[kernel] flash_attention (MLA 48/48/32)") == 1
    assert "ragged_err=0.000e+00" in out and "f32_err=0.000e+00" in out


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
    # timed without lse and with it, in turns; the lse checked in each case
    assert "ms=1.0000 (readings 1.0000 1.0000) ms_lse=1.0000" in out
    assert "lse_err=0.000e+00 (the four cases' worst" in out


def test_flash_kernel_phase_fails_on_a_wrong_lse(smoke, monkeypatch):
    """The forward's lse is held within 1e-3 of the plain one."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    real = fa.flash_attention_fwd

    def off(*a, **kw):
        out, lse = real(*a, **kw)
        return out, (None if lse is None else lse + 2e-3)
    monkeypatch.setattr(fa, "flash_attention_fwd", off)
    with pytest.raises(smoke.CheckFailed, match="lse max abs err"):
        smoke.flash_kernel_phase(0, "cpu", device="cpu",
                                 shape=(2, 4, 2, 48, 16), ragged=40,
                                 wide=(1, 7, 1, 40, 16))


def test_charge_kernel_rows_and_the_one_kernel_check(smoke, cpu_model,
                                                    monkeypatch, capsys):
    """The charge and state kernels' rows on a small batch: each checked
    against its plain version and timed with its GB/s (the state kernel
    also at two further shapes, printed and not returned); the profiler
    check passes a call that runs one device operation and fails one
    that runs two."""
    from repro_torch.core import model_api
    _, tb = smoke.build_workload(0, 3, 150, 2048, "cpu")
    models = {k: model_api.make_estimator(k, cpu_model) for k in smoke.KINDS}
    rows = smoke.kernel_phase(tb, models, "cpu", state_shapes={
        "batch-long": (4, 4096), "batch-short": (24, 512)})
    names = [r["name"] for r in rows]
    assert names == ["batched_features", "vampire_charge",
                     "vampire_charge_surface", "micron_charge",
                     "micron_charge_surface", "drampower_charge",
                     "drampower_charge_surface", "batched_state"]
    assert all(r["bound"][1] == "bytes" for r in rows)
    out = capsys.readouterr().out
    assert out.count("[kernel]") == 10 and out.count("gb_per_s=") == 9
    assert "shape=batch-short (T=24, N=512)" in out
    monkeypatch.setattr(smoke, "device_kernels", lambda fn: ["kernel"])
    smoke.one_kernel_phase(rows)
    assert capsys.readouterr().out.count("one device operation") == 7
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
    assert "flash_launches=2 (prefill 2, decode 0)" in out
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


def test_serve_mla_phase_at_smoke_size(smoke, monkeypatch, capsys):
    real = smoke.read_counters
    monkeypatch.setattr(smoke, "read_counters", lambda: {
        k: (2 if k == "flash_attention" else max(v, 1))
        for k, v in real().items()})
    launched = smoke.serve_mla_phase(0, "cpu", device="cpu", smoke=True,
                                     batch=2, prompt_len=40,
                                     decode_tokens=4)
    assert launched["flash_attention"] == 2       # one per layer
    out = capsys.readouterr().out
    assert out.count("[serve-mla]") == 6
    assert "deepseek-v2-lite-16b-smoke: layers=2" in out
    assert "flash_launches=2 (prefill 2, decode 0)" in out
    assert "power[vampire] impl=cuda" in out
    assert "same_bits_twice=True" in out and "2 layers" in out


def test_routed_alike_reports_each_rows_first_flip(smoke):
    """Rows whose last token takes the same experts at every layer in the
    prefill and the decode step, and for the others the first layer that
    differs with the smaller margin."""
    same = torch.tensor([[0, 3], [1, 2], [4, 5]])
    other = torch.tensor([[0, 3], [1, 6], [4, 5]])
    wide = torch.tensor([0.5, 0.5, 0.5])
    near = torch.tensor([0.5, 0.001, 0.5])
    rows, flips = smoke.routed_alike(
        [(same, wide), (other, near), (same, wide)],
        [(same, wide), (same, wide), (other, wide)])
    assert rows.tolist() == [True, False, True]
    assert flips == {1: (1, pytest.approx(0.001))}


def _flash_launches(smoke, monkeypatch, n):
    """``read_counters`` with ``n`` flash launches (CPU tensors launch
    nothing) and every other kernel launched."""
    real = smoke.read_counters
    monkeypatch.setattr(smoke, "read_counters", lambda: {
        k: (n if k == "flash_attention" else max(v, 1))
        for k, v in real().items()})


def test_flash_cross_kernel_phase_rows(smoke, capsys):
    rows = smoke.flash_cross_kernel_phase(
        0, "cpu", device="cpu", xattn=(1, 4, 2, 40, 37, 16),
        encoder=(1, 2, 30, 16), decode_keys=(30, 37))
    assert [r["name"] for r in rows] == [
        "flash_attention_xattn", "flash_attention_encoder",
        "flash_attention_xdecode"]
    assert all(r["err"] == 0.0 and r["library_ms"] == 1.0 for r in rows)
    assert rows[0]["fn"]().shape == (4, 40, 16)
    assert rows[2]["fn"]().shape == (4, 1, 16)
    assert rows[2]["bound"][1] == "bytes"
    out = capsys.readouterr().out
    assert out.count("[kernel] flash_attention (") == 3
    assert "Skv=37/group4/float32=0.000e+00" in out


def test_f7_phase_checks_gradients_through_flash_attention(smoke, capsys):
    """F7 repaired: q, k and v get gradients through ``FlashAttention``
    (on CPU tensors its plain directions), one launch each read as made."""
    smoke.f7_phase("cpu", device="cpu")
    out = capsys.readouterr().out
    assert "[faults] F7 repaired" in out and "dq/dk/dv err" in out


def test_f7_phase_fails_without_one_launch_of_each_kernel(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "read_counters", lambda: dict.fromkeys(
        ["flash_attention", "flash_attention_bwd_prep",
         "flash_attention_bwd_dkdv", "flash_attention_bwd_dq"], 0))
    with pytest.raises(smoke.CheckFailed, match="F7: launches"):
        smoke.f7_phase("cpu", device="cpu")


def test_flash_bwd_kernel_phase_rows(smoke, capsys):
    rows = smoke.flash_bwd_kernel_phase(0, "cpu", device="cpu",
                                        shape=(1, 4, 2, 40, 16),
                                        small=(1, 2, 1, 24, 16))
    assert [r["name"] for r in rows] == [
        "flash_attention_bwd_prep", "flash_attention_bwd_dkdv",
        "flash_attention_bwd_dq"]
    assert [r["library_ms"] for r in rows] == [1.0, 1.0, 1.0]
    assert rows[0]["bound"][1] == "bytes"
    assert all(r["bound"][1] in ("bytes", "operations") for r in rows)
    # K0's delta is its plain version's on the CPU; K1 and K2 (there the
    # plain backward on the forward's lse) against the plain backward that
    # forms its own softmax differ by rounding: at most one bf16 step of
    # the largest gradient
    assert rows[0]["err"] == 0.0
    assert all(r["err"] <= 2 ** -8 for r in rows[1:])
    assert all(r["source"].endswith("flash_attention_bwd.cu") for r in rows)
    out = capsys.readouterr().out
    assert out.count("[kernel] flash_attention_bwd_") == 3
    assert "(torch.linalg.vecdot, a bf16 result)" in out
    assert "K0+K1+K2" in out and "K0's delta 0.000e+00" in out


def test_bwd_work_counts_the_backward(smoke):
    """At one qwen2.5-3b train layer: K0 reads out and dout and writes
    delta (67.6 MB, bound by bytes at 0.0202 ms) with one float32
    multiply-add an element; K1 computes S, dP, dV and dK (twice the
    forward's operations), K2 S, dP and dQ (1.5 times); the bytes count
    each input read once and each output written once."""
    work = smoke.bwd_work(64, 8, 2048, 128, 128, 2)
    fwd = smoke.attention_flops(64, 2048, 2048, 128, True)
    q, kv, stats = 64 * 2048 * 128 * 2, 8 * 2048 * 128 * 2, 2 * 64 * 2048 * 4
    assert work["flash_attention_bwd_prep"] == (
        2 * q + 64 * 2048 * 4, 2 * 64 * 2048 * 128, smoke.FP32_OPS_PER_S)
    assert [work[k][1] / fwd for k in ("flash_attention_bwd_dkdv",
                                       "flash_attention_bwd_dq")] == [2.0,
                                                                      1.5]
    assert work["flash_attention_bwd_dq"][0] == 3 * q + 2 * kv + stats
    ms, by = smoke.bound(*work["flash_attention_bwd_prep"])
    assert by == "bytes" and round(ms, 4) == 0.0202
    assert [smoke.bound(*work[k])[1] for k in ("flash_attention_bwd_dkdv",
                                               "flash_attention_bwd_dq")] \
        == ["operations", "operations"]


def _train_launches(smoke, monkeypatch, fwd, bwd):
    names = ("flash_attention_bwd_prep", "flash_attention_bwd_dkdv",
             "flash_attention_bwd_dq")
    real = smoke.read_counters
    monkeypatch.setattr(smoke, "read_counters", lambda: {
        k: (fwd if k == "flash_attention" else bwd if k in names
            else max(v, 1)) for k, v in real().items()})


def test_train_phase_at_smoke_size(smoke, monkeypatch, capsys):
    from repro_torch.configs import registry
    layers = registry.get_config("qwen2.5-3b", smoke=True).n_layers
    _train_launches(smoke, monkeypatch, 2 * layers * 3, layers * 3)
    launched = smoke.train_phase(0, "cpu", device="cpu", smoke=True,
                                 batch=2, seq=32, steps=3)
    assert launched["flash_attention_bwd_dq"] == layers * 3
    out = capsys.readouterr().out
    assert "tokens_per_s=" in out and "step_s=" in out
    assert "max_memory_allocated_gb=not measured predicted_gb=" in out
    assert "warm step: device time not measured" in out
    assert "est. HBM energy" in out
    _train_launches(smoke, monkeypatch, 2 * layers * 3, 0)
    with pytest.raises(smoke.CheckFailed, match="train: launches"):
        smoke.train_phase(0, "cpu", device="cpu", smoke=True, batch=2,
                          seq=32, steps=3)


def test_train_work_counts_the_step(smoke):
    """qwen2.5-3b at batch 4 x 2048: about 1.95e14 operations, 0.197 s at
    989 TFLOP/s (the recompute stops before each layer's down
    projection)."""
    from repro_torch.configs import registry
    cfg = registry.get_config("qwen2.5-3b")
    ops = smoke.train_work(cfg, 4, 2048)
    assert 1.9e14 < ops < 2.0e14
    with pytest.raises(ValueError, match="dense GQA"):
        smoke.train_work(registry.get_config("mamba2-780m"), 4, 2048)


def test_train_grad_phase_at_smoke_size(smoke, monkeypatch, capsys):
    real = smoke.read_counters
    monkeypatch.setattr(smoke, "read_counters", lambda: {
        k: v + 1 for k, v in real().items()})
    smoke.train_grad_phase(0, "cpu", device="cpu",
                           archs=["qwen2.5-3b", "deepseek-v2-lite-16b"])
    out = capsys.readouterr().out
    assert out.count("kernel vs plain gradients") == 2
    assert "bf16 leaves above 2e-2 of their largest: 0 []" in out


def test_train_ckpt_phase(smoke, capsys):
    smoke.train_ckpt_phase(0, "cpu", device="cpu")
    out = capsys.readouterr().out
    assert "recoveries=1 steps_run=15" in out and "bit-equal=True" in out


def test_prefill_work_counts_every_layer_kind(smoke):
    """mamba2-780m's projections (2 x tokens x 14.6 M weights x 48 layers)
    and its float32 scan at the float32 rate; whisper's encoder and
    cross-attention add to the decoder's work."""
    from repro_torch.configs import registry
    cfg = registry.get_config("mamba2-780m")
    ms, by = smoke.prefill_work(cfg, 4, 2048, 1)
    proj = 2 * 8192 * 48 * (1536 * (2 * 3072 + 256 + 48) + 3072 * 1536)
    scan = 48 * (2 * 8192 * 256 * (128 + 48 * 64) + 4 * 8192 * 48 * 128 * 64)
    want = (proj + 2 * 4 * 1536 * cfg.vocab_padded) / smoke.BF16_OPS_PER_S \
        + scan / smoke.FP32_OPS_PER_S
    assert by == "operations" and ms == pytest.approx(want * 1e3, rel=1e-9)
    whisper = registry.get_config("whisper-small")
    plain = registry.get_config("qwen2.5-3b")
    assert smoke.prefill_work(whisper, 4, 416, 1)[0] > smoke.prefill_work(
        __import__("dataclasses").replace(whisper, n_encoder_layers=0),
        4, 416, 1)[0] > 0
    assert smoke.prefill_work(plain, 4, 2048, 1)[1] == "operations"


def test_serve_ssm_phase_at_smoke_size(smoke, monkeypatch, capsys):
    _flash_launches(smoke, monkeypatch, 0)
    launched = smoke.serve_ssm_phase(0, "cpu", device="cpu", smoke=True,
                                     batch=2, prompt_len=21, decode_tokens=4,
                                     scan_len=21)
    assert launched["flash_attention"] == 0
    out = capsys.readouterr().out
    assert "mamba2-780m-smoke: layers=2 {'mamba': 2}" in out
    assert "same_bits_twice=True" in out and "chunked_vs_recurrent" in out
    assert "flash_launches=0 (prefill 0, decode 0)" in out


def test_serve_xattn_phase_at_smoke_size(smoke, monkeypatch, capsys):
    _flash_launches(smoke, monkeypatch, 5 + 3)    # 5 layers, 3 steps x 1
    launched, calls = smoke.serve_xattn_phase(
        0, "cpu", device="cpu", smoke=True, batch=2, prompt_len=21,
        decode_tokens=4)
    assert calls == {"causal": 4, "cross": 1, "decode": 3}
    assert launched["flash_attention"] == 8
    out = capsys.readouterr().out
    assert "llama-3.2-vision-11b-smoke: layers=5" in out
    assert "kernel vs plain attention worst by call class" in out


def test_serve_enc_phase_at_smoke_size(smoke, monkeypatch, capsys):
    _flash_launches(smoke, monkeypatch, 2 + 2 + 2 + 2 * 3)
    _, calls = smoke.serve_enc_phase(0, "cpu", device="cpu", smoke=True,
                                     batch=2, prompt_len=20,
                                     decode_tokens=4)
    assert calls == {"encoder": 2, "causal": 2, "cross": 2, "decode": 6}
    out = capsys.readouterr().out
    assert "whisper-small-smoke: layers=2" in out
    assert "encoder_layers=2 aux_seq=16" in out


def test_serve_hybrid_phase(smoke, monkeypatch, capsys):
    _flash_launches(smoke, monkeypatch, 1)
    launched = smoke.serve_hybrid_phase(0, "cpu", device="cpu", batch=2,
                                        prompt_len=20)
    assert launched["flash_attention"] == 1
    out = capsys.readouterr().out
    assert "flash launches in the prefill 1 (one a period)" in out


@pytest.fixture()
def no_process_group():
    """The dry run's fake process group is process state: end it after."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def test_dryrun_phase_checks_the_count_and_the_peak(smoke, no_process_group,
                                                    monkeypatch, capsys):
    """``[dryrun]`` at smoke widths on fake tensors: its checks pass on the
    traced step's own peak, and fail on a wrong operation count and on a
    measured peak 10 % off either way."""
    from repro_torch.configs import registry
    from repro_torch.launch import mesh, steps
    spec = registry.ShapeSpec("train_32", "train", 32, 2)
    res = steps.dryrun_cell("qwen2.5-3b", spec,
                            mesh.make_local_mesh(1, 1, fake=True),
                            multi_pod=False, smoke=True)
    peak = res["memory"]["peak_bytes_est"]
    train = {"peak": peak, "predicted": peak, "step_s": 1.0}
    kw = dict(smoke=True, batch=2, seq=32, cli_mesh=None)
    smoke.dryrun_phase("cpu", train, **kw)
    out = capsys.readouterr().out
    assert "[dryrun] qwen2.5-3b-smoke batch=2 seq=32" in out
    assert "(miss +0.0000)" in out and "mfu=" in out
    for off in (1.1, 1 / 1.1):
        with pytest.raises(smoke.CheckFailed, match="predicted peak"):
            smoke.dryrun_phase("cpu", dict(train, peak=int(peak * off)),
                               **kw)
    real = smoke.train_work
    monkeypatch.setattr(smoke, "train_work",
                        lambda cfg, b, s: real(cfg, b, s) + 1)
    with pytest.raises(smoke.CheckFailed, match="operations"):
        smoke.dryrun_phase("cpu", train, **kw)


def test_dryrun_cli_check_fails_on_a_failed_cell(smoke, monkeypatch, capsys):
    import subprocess
    monkeypatch.setattr(smoke.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(
                            a, 1, stdout="[FAIL] yi-34b__train_4k__16x16\n",
                            stderr=""))
    with pytest.raises(smoke.CheckFailed, match="the CLI gave rc 1"):
        smoke.dryrun_cli("cpu", "pod")
    assert "failed=1" in capsys.readouterr().out


def test_dryrun_cli_wants_every_cell_but_the_mamba2_ones(smoke, monkeypatch):
    """On the pod mesh the CLI must print 32 ``[ok]`` and no
    ``[not-ported]``: since the Mamba2 and jamba cells are ported, the 24
    other cells with those 8 ``[not-ported]`` fail the check."""
    import subprocess
    lines = ["[ok]   a"] * 24 + ["[not-ported] b"] * 8
    monkeypatch.setattr(smoke.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(
                            a, 0, stdout="\n".join(lines), stderr=""))
    with pytest.raises(smoke.CheckFailed,
                       match=r"'\[ok\]': 32, '\[not-ported\]': 0"):
        smoke.dryrun_cli("cpu", "pod")
