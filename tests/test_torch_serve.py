"""The port's serving entry point against the reference's: ``run`` at smoke
size on the CPU returns the reference's keys and shapes (qwen2.5-3b, and
deepseek-v2-lite-16b's MLA + MoE); ``power_report``
scores the same logits, tokens, step time and traffic to the reference's
energies (the reference's HLO traffic count is patched, in this test only,
to the port's analytic ``decode_traffic_bytes``); that count equals a
hand count, for a K/V cache and for MLA's latent cache; and a protocol-illegal trace is refused with the reference's
structured error."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import idd_loops
from repro.launch import serve as rserve
from repro_torch.analysis import trace_lint as plint
from repro_torch.configs import registry as preg
from repro_torch.core import dram as pdram
from repro_torch.core import traces as ptraces
from repro_torch.launch import serve as pserve
from repro_torch.models.lm import LM

MODEL = str(pathlib.Path(__file__).resolve().parents[1] / "src"
            / "repro_torch" / "data" / "vampire_quickfit_v2.npz")
JOB = dict(arch="qwen2.5-3b", smoke=True, batch=2, prompt_len=8,
           decode_tokens=4, power_report=True, power_impl="vectorized",
           vampire_path=MODEL)


@pytest.fixture(scope="module")
def runs():
    ref = rserve.run(rserve.ServeJob(**JOB))
    port = pserve.run(pserve.ServeJob(**JOB, device="cpu"))
    return ref, port


def test_run_returns_the_reference_keys_and_shapes(runs):
    ref, port = runs
    assert set(port) == set(ref)
    assert port["tokens"].shape == ref["tokens"].shape == (2, 4)
    assert port["tokens"].dtype == ref["tokens"].dtype
    pw, rpw = port["power"], ref["power"]
    assert set(pw) == set(rpw)
    assert set(pw["serving"]) == set(rpw["serving"])
    assert pw["ddr_energy_pj_per_seq_step"].shape == (2, 3)
    assert (pw["ddr_energy_pj_per_seq_step"] > 0).all()
    assert pw["traffic_bytes_per_step"] > 0 and pw["hbm_step_energy_uj"] > 0
    assert 0.0 <= pw["hbm_ones_frac"] <= 1.0
    assert pw["serving"]["admitted"] == 2 and pw["serving"]["rejected"] == 0
    assert port["prefill_s"] > 0 and port["tokens_per_s"] > 0


def test_mla_moe_run_returns_the_reference_keys_and_shapes():
    job = dict(JOB, arch="deepseek-v2-lite-16b", prompt_len=40,
               decode_tokens=3)
    ref = rserve.run(rserve.ServeJob(**job))
    port = pserve.run(pserve.ServeJob(**job, device="cpu"))
    assert set(port) == set(ref)
    assert port["tokens"].shape == ref["tokens"].shape == (2, 3)
    assert port["tokens"].dtype == ref["tokens"].dtype
    assert (port["tokens"] < 256).all()
    pw, rpw = port["power"], ref["power"]
    assert set(pw) == set(rpw) and set(pw["serving"]) == set(rpw["serving"])
    assert pw["ddr_energy_pj_per_seq_step"].shape == (2, 3)
    assert (pw["ddr_energy_pj_per_seq_step"] > 0).all()
    assert pw["serving"]["admitted"] == 2 and pw["serving"]["rejected"] == 0


def test_temperature_sampling_and_mesh_arguments():
    res = pserve.run(pserve.ServeJob(arch="granite-8b", batch=2,
                                     prompt_len=5, decode_tokens=3,
                                     temperature=0.7, device="cpu"))
    assert res["tokens"].shape == (2, 3) and "power" not in res
    assert (res["tokens"] < preg.get_config("granite-8b", smoke=True).vocab
            ).all()
    # a mesh of two devices needs two ranks (the mesh runs over four
    # processes in tests/test_torch_mesh.py)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        pserve.run(pserve.ServeJob(arch="qwen2.5-3b", data=2, device="cpu"))


def _decode_inputs(batch, steps, vocab_padded, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((batch, vocab_padded)) * 3
              ).astype(np.float32)
    tokens = rng.integers(0, 256, (batch, steps)).astype(np.int32)
    return logits, tokens


@pytest.mark.parametrize("power_model", ["vampire", "micron", "drampower"])
def test_power_report_matches_the_reference(power_model, monkeypatch):
    cfg = preg.get_config("qwen2.5-3b", smoke=True)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    batch = 3
    caches = lm.prefill(params, torch.zeros((batch, 8), dtype=torch.long),
                        max_len=12)[1]
    traffic = pserve.decode_traffic_bytes(lm, params, caches, batch)
    logits, tokens = _decode_inputs(batch, 4, cfg.vocab_padded)
    job = dict(JOB, batch=batch, power_model=power_model)
    monkeypatch.setattr(rserve, "_decode_traffic_bytes", lambda c: traffic)
    want = rserve.power_report(rserve.ServeJob(**job), None,
                               jnp.asarray(logits), jnp.asarray(tokens),
                               n_data=1, step_seconds=2e-3)
    got = pserve.power_report(pserve.ServeJob(**job, device="cpu"), traffic,
                              torch.from_numpy(logits),
                              torch.from_numpy(tokens), step_seconds=2e-3)
    assert set(got) == set(want)
    assert got["vendors"] == want["vendors"]
    assert got["power_model"] == want["power_model"] == power_model
    assert got["traffic_bytes_per_step"] == want["traffic_bytes_per_step"]
    np.testing.assert_allclose(got["ddr_energy_pj_per_seq_step"],
                               want["ddr_energy_pj_per_seq_step"], rtol=1e-5)
    np.testing.assert_allclose(got["ddr_energy_uj_per_token_mean"],
                               want["ddr_energy_uj_per_token_mean"],
                               rtol=1e-5)
    for key in ("admitted", "rejected", "dispatches", "dispatched_traces",
                "completed", "batch_fill", "engine_programs"):
        assert got["serving"][key] == want["serving"][key], key
    if power_model == "vampire":
        np.testing.assert_allclose(got["hbm_step_energy_uj"],
                                   want["hbm_step_energy_uj"], rtol=1e-6)
        assert got["hbm_ones_frac"] == want["hbm_ones_frac"]
        assert got["hbm_toggle_frac"] == want["hbm_toggle_frac"]


@pytest.mark.parametrize("kv_dtype", [None, torch.int8])
def test_decode_traffic_bytes_equals_a_hand_count(kv_dtype):
    cfg = preg.get_config("granite-8b", smoke=True)    # untied, no bias
    lm = LM(cfg)
    lm.kv_cache_dtype = kv_dtype
    params = lm.init(torch.Generator().manual_seed(0))
    b, max_len = 3, 20
    meta = lm.init_cache_meta(b, max_len)
    caches = {"sub0": {k: torch.zeros(m.shape, dtype=m.dtype)
                       for k, m in meta["sub0"].items()}, "pos": 7}
    d, f, v, el = cfg.d_model, cfg.d_ff, cfg.vocab_padded, 2   # bf16
    qkv = d * (cfg.n_heads + 2 * cfg.n_kv) * cfg.d_head
    per_layer = qkv + cfg.n_heads * cfg.d_head * d + 3 * d * f + 2 * d
    weights = (2 * v * d + d + cfg.n_layers * per_layer) * el
    slot = 2 * cfg.n_layers * b * cfg.n_kv * (
        cfg.d_head * (1 if kv_dtype is torch.int8 else el)
        + (4 if kv_dtype is torch.int8 else 0))
    want = weights + slot * max_len + slot + b * v * 4
    assert pserve.decode_traffic_bytes(lm, params, caches, b) == want


def test_corrupt_trace_is_refused_with_a_structured_error(monkeypatch):
    good = pdram.make_trace(*[np.asarray(f)
                              for f in idd_loops.idd0(reps=2)])
    cmd, bank, dt = (np.array(x, np.int32) for x in zip(
        *[(1, 0, 4), (3, 0, 1)]))                      # RD inside tRCD
    z = np.zeros(2, np.int32)
    corrupt = pdram.CommandTrace(*(torch.from_numpy(x) for x in (
        cmd, bank, z, z, np.zeros((2, 16), np.int32), dt)))
    with pytest.raises(plint.TraceProtocolError) as ei:
        pserve.lint_ingested([good, corrupt])
    err = ei.value
    assert err.origin == "serve.power_report"
    (d,) = err.diagnostics
    assert (d.rule, d.trace_index, d.cmd_index, d.bank) == ("tRCD", 1, 1, 0)
    # power_report refuses the same way when its own traces are illegal
    monkeypatch.setattr(ptraces, "app_trace", lambda *a, **k: corrupt)
    logits, tokens = _decode_inputs(2, 3, 512)
    with pytest.raises(plint.TraceProtocolError) as ei:
        pserve.power_report(pserve.ServeJob(**JOB, device="cpu"), 1e6,
                            torch.from_numpy(logits),
                            torch.from_numpy(tokens), step_seconds=1e-3)
    assert ei.value.origin == "serve.power_report"
    assert {d.rule for d in ei.value.diagnostics} == {"tRCD"}


def test_decode_traffic_bytes_of_an_mla_moe_cache():
    """deepseek-v2-lite-16b's smoke widths: MLA weights, every routed and
    shared expert's weights, the latent ``ckv`` and RoPE key ``kr`` read
    whole, one new slot of each written, and the float32 logits."""
    cfg = preg.get_config("deepseek-v2-lite-16b", smoke=True)
    lm = LM(cfg)
    lm.kv_cache_dtype = torch.int8              # does not apply to MLA
    params = lm.init(torch.Generator().manual_seed(0))
    b, max_len = 3, 20
    meta = lm.init_cache_meta(b, max_len)
    caches = {"sub0": {k: torch.zeros(m.shape, dtype=m.dtype)
                       for k, m in meta["sub0"].items()}, "pos": 7}
    d, v, el, h = cfg.d_model, cfg.vocab_padded, 2, cfg.n_heads   # bf16
    m, e = cfg.mla, cfg.moe
    mla = (d * h * (m.d_nope + m.d_rope) + d * m.kv_lora + d * m.d_rope
           + m.kv_lora * h * (m.d_nope + m.d_v) + h * m.d_v * d + d
           + m.kv_lora)
    moe = (d * e.n_experts + 3 * e.n_experts * d * e.d_ff_expert + d
           + 3 * d * e.d_ff_expert * e.n_shared)
    weights = (2 * v * d + d + cfg.n_layers * (mla + moe)) * el
    slot = cfg.n_layers * b * (m.kv_lora + m.d_rope) * el
    want = weights + slot * max_len + slot + b * v * 4
    assert pserve.decode_traffic_bytes(lm, params, caches, b) == want


@pytest.mark.parametrize("arch", ["mamba2-780m", "whisper-small"])
def test_ssm_and_encoder_runs_return_the_reference_keys_and_shapes(arch):
    """mamba2-780m (no attention: flash is never called) and whisper-small
    (the reference's zero frame embeddings, fed through prefill)."""
    from repro_torch.kernels.flash_attention import flash_attention as pfa
    job = dict(JOB, arch=arch, prompt_len=21, decode_tokens=3)
    ref = rserve.run(rserve.ServeJob(**job))
    before = pfa.flash_attention.launches
    port = pserve.run(pserve.ServeJob(**job, device="cpu"))
    assert pfa.flash_attention.launches == before
    assert set(port) == set(ref)
    assert port["tokens"].shape == ref["tokens"].shape == (2, 3)
    assert (port["tokens"] < preg.get_config(arch, smoke=True).vocab).all()
    pw, rpw = port["power"], ref["power"]
    assert set(pw) == set(rpw) and set(pw["serving"]) == set(rpw["serving"])
    assert (pw["ddr_energy_pj_per_seq_step"] > 0).all()


def test_cli_serves_mamba2_on_the_cpu(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch mamba2-780m --smoke
    --device cpu``."""
    import sys
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "mamba2-780m", "--smoke", "--device", "cpu",
        "--batch", "2", "--prompt-len", "12", "--decode-tokens", "3"])
    pserve.main()
    out = capsys.readouterr().out
    assert out.startswith("prefill=") and "tok/s" in out


def test_decode_traffic_bytes_of_ssm_and_cross_caches():
    """jamba's smoke widths (Mamba2 state and conv window, read and
    written whole; one attention layer in 8) and whisper's (the cross K/V
    read whole, never written by a decode step)."""
    for arch in ("jamba-1.5-large-398b", "whisper-small"):
        cfg = preg.get_config(arch, smoke=True)
        lm = LM(cfg)
        params = lm.init(torch.Generator().manual_seed(0))
        b, max_len = 3, 20
        meta = lm.init_cache_meta(b, max_len)
        caches = {sub: {k: torch.zeros(m.shape, dtype=m.dtype)
                        for k, m in leaves.items()}
                  for sub, leaves in meta.items() if sub != "pos"}
        caches["pos"] = 7
        read = sum(t.numel() * t.element_size()
                   for leaves in caches.values() if isinstance(leaves, dict)
                   for t in leaves.values())
        slot = 2 * lm.repeats * b * cfg.n_kv * cfg.d_head * 2   # bf16 K/V
        if arch.startswith("jamba"):
            s = cfg.ssm
            nh = s.n_heads(cfg.d_model)
            conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
            per = b * (nh * s.d_state * s.head_dim * 4
                       + (s.conv_width - 1) * conv_dim * 2)
            written = 7 * lm.repeats * per + slot
        else:
            written = slot                  # the cross K/V is not written
        weights = pserve.tree_nbytes(params)
        want = weights + read + written + b * cfg.vocab_padded * 4
        assert pserve.decode_traffic_bytes(lm, params, caches, b) == want
