"""The port's dense decoder against the reference's: the reference's
``LM.init`` weights carried across by ``convert.lm_params_from_jax``,
then prefill, the decode cache and three decode steps compared on the
smoke configs of qwen2.5-3b (tied embeddings, QKV bias) and granite-8b
(untied, no bias), in float32 at a prompt of 40 (not a multiple of
``attention_block=32``) and in bf16 at the reference's teacher-forcing
bar; the int8 KV cache at the bar of ``tests/test_models.py``; and the
refusal of a layer kind the port does not know."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import layers as RL
from repro.models.lm import LM as RLM
from repro.models.meta import materialize as rmaterialize
from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.kernels.flash_attention import flash_attention as pfa
from repro_torch.models import layers as PL
from repro_torch.models.lm import LM as PLM
from repro_torch.models.meta import materialize as pmaterialize

ARCHS = ["qwen2.5-3b", "granite-8b"]
B, S, STEPS = 2, 40, 3
TOL = dict(atol=1e-4, rtol=1e-4)


def _bar(got, want):
    """The reference's teacher-forcing bar (tests/test_models.py)."""
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err < 0.15 * (float(np.std(want)) + 1e-6) + 0.05, err


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _pair(arch, dtype):
    """(reference cfg, port cfg, reference LM, port LM, reference params,
    port params) with the QKV biases made non-zero."""
    rcfg = dataclasses.replace(rreg.get_config(arch, smoke=True), dtype=dtype)
    pcfg = dataclasses.replace(preg.get_config(arch, smoke=True), dtype=dtype)
    rlm, plm = RLM(rcfg), PLM(pcfg)
    params = _np_tree(rlm.init(jax.random.key(0)))
    mixer = params["layers"]["sub0"]["mixer"]
    rng = np.random.default_rng(1)
    for name in ("bq", "bk", "bv"):
        if name in mixer:
            mixer[name] = (rng.standard_normal(mixer[name].shape) * 0.1
                           ).astype(mixer[name].dtype)
    rparams = jax.tree_util.tree_map(jnp.asarray, params)
    return rcfg, pcfg, rlm, plm, rparams, convert.lm_params_from_jax(
        params, pcfg)


def _run_reference(rlm, rparams, tokens):
    prefill = jax.jit(lambda p, t: rlm.prefill(p, t, max_len=S + STEPS))
    logits, caches = prefill(rparams, jnp.asarray(tokens[:, :S]))
    first = _np_tree(caches)
    step = jax.jit(rlm.decode_step)
    outs = [np.asarray(logits)]
    for i in range(STEPS):
        logits, caches = step(rparams, caches,
                              jnp.asarray(tokens[:, S + i:S + i + 1]))
        outs.append(np.asarray(logits))
    return outs, first


def _run_port(plm, pparams, tokens):
    tok = torch.from_numpy(tokens).long()
    logits, caches = plm.prefill(pparams, tok[:, :S], max_len=S + STEPS)
    first = {k: v.clone() for k, v in caches["sub0"].items()}
    outs = [logits]
    for i in range(STEPS):
        logits, caches = plm.decode_step(pparams, caches,
                                         tok[:, S + i:S + i + 1])
        outs.append(logits)
    return outs, first


@pytest.fixture(scope="module", params=ARCHS)
def f32_run(request):
    rcfg, pcfg, rlm, plm, rparams, pparams = _pair(request.param, "float32")
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab, size=(B, S + STEPS)).astype(np.int32)
    return (_run_reference(rlm, rparams, tokens),
            _run_port(plm, pparams, tokens), pcfg)


def test_prefill_logits_and_cache_match_at_f32(f32_run):
    (rlog, rcache), (plog, pcache), cfg = f32_run
    assert plog[0].shape == (B, cfg.vocab_padded)
    np.testing.assert_allclose(plog[0].numpy(), rlog[0], **TOL)
    for name in ("k", "v"):
        got, want = pcache[name].numpy(), rcache["sub0"][name]
        assert got.shape == want.shape == (cfg.n_layers, B, S + STEPS,
                                           cfg.n_kv, cfg.d_head)
        np.testing.assert_allclose(got, want, **TOL)
    assert int(rcache["pos"]) == S
    # pad-vocab logits are masked inert
    assert bool((plog[0][:, cfg.vocab:] <= -1e29).all())


def test_decode_steps_match_at_f32_with_equal_greedy_tokens(f32_run):
    (rlog, _), (plog, _), _ = f32_run
    for want, got in zip(rlog[1:], plog[1:]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      want.argmax(-1))


def test_caches_carry_across_and_decode_on():
    """A JAX prefill's cache, converted, decodes in the port to the same
    logits as the reference's own decode step."""
    arch = "qwen2.5-3b"
    _, pcfg, rlm, plm, rparams, pparams = _pair(arch, "float32")
    tokens = np.random.default_rng(3).integers(0, pcfg.vocab, (B, S + 1))
    _, caches = rlm.prefill(rparams, jnp.asarray(tokens[:, :S]),
                            max_len=S + 1)
    want, _ = rlm.decode_step(rparams, caches, jnp.asarray(tokens[:, S:]))
    got, new = plm.decode_step(pparams,
                               convert.lm_caches_from_jax(_np_tree(caches)),
                               torch.from_numpy(tokens[:, S:]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert new["pos"] == S + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_the_teacher_forcing_bar(arch):
    rcfg, _, rlm, plm, rparams, pparams = _pair(arch, "bfloat16")
    tokens = np.random.default_rng(4).integers(0, rcfg.vocab, (B, S))
    want, _ = rlm.forward(rparams, jnp.asarray(tokens))
    got, _ = plm.forward(pparams, torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    _bar(got.numpy()[..., :rcfg.vocab], np.asarray(want)[..., :rcfg.vocab])
    # the port's own decode against its own teacher forcing
    _, caches = plm.prefill(pparams, torch.from_numpy(tokens[:, :S - 1]),
                            max_len=S)
    step, _ = plm.decode_step(pparams, caches,
                              torch.from_numpy(tokens[:, S - 1:]))
    _bar(step.numpy()[:, :rcfg.vocab], got[:, S - 1].numpy()[:, :rcfg.vocab])
    assert pfa.flash_attention.launches == 0


def _attn_case():
    cfg = preg.get_config("granite-8b", smoke=True)
    params_np = _np_tree(rmaterialize(RL.attn_meta(cfg), jax.random.key(11),
                                      dtype=jnp.float32))
    rng = np.random.default_rng(12)
    b, s = 2, 24
    x = (rng.standard_normal((b, 1, cfg.d_model)) * 0.5).astype(np.float32)
    kv = [(rng.standard_normal((b, s, cfg.n_kv, cfg.d_head)) * 0.5
           ).astype(np.float32) for _ in range(2)]
    return cfg, params_np, x, kv, s - 4


def test_int8_kv_cache_decode_close():
    cfg, params_np, x, (k0, v0), pos = _attn_case()
    rparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    pparams = {k: torch.from_numpy(v.copy()) for k, v in params_np.items()}
    o_full, _ = PL.attn_decode(pparams, torch.from_numpy(x), {
        "k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
        "pos": pos}, cfg)
    kq, ks = PL.quantize_kv(torch.from_numpy(k0))
    vq, vs = PL.quantize_kv(torch.from_numpy(v0))
    rkq, rks = RL.quantize_kv(jnp.asarray(k0))
    rvq, rvs = RL.quantize_kv(jnp.asarray(v0))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(rkq))
    np.testing.assert_array_equal(vq.numpy(), np.asarray(rvq))
    cache = {"k": kq, "v": vq, "k_s": ks, "v_s": vs, "pos": pos}
    o_q, nc = PL.attn_decode(pparams, torch.from_numpy(x), cache, cfg)
    assert nc["k"].dtype == torch.int8 and nc["pos"] == pos + 1
    scale = float(o_full.std()) + 1e-6
    assert float((o_q - o_full).abs().max()) < 0.1 * scale + 0.02
    # the reference's int8 decode on the same cache
    o_ref, _ = RL.attn_decode(rparams, jnp.asarray(x), {
        "k": rkq, "v": rvq, "k_s": rks, "v_s": rvs,
        "pos": jnp.asarray(pos, jnp.int32)}, cfg)
    assert float(np.abs(o_q.numpy() - np.asarray(o_ref)).max()) \
        < 0.1 * scale + 0.02


def test_int8_cache_layout_and_lm_decode():
    cfg = dataclasses.replace(preg.get_config("qwen2.5-3b", smoke=True),
                              dtype="float32")
    plm = PLM(cfg)
    plm.kv_cache_dtype = torch.int8
    meta = plm.init_cache_meta(B, 12)
    assert meta["sub0"]["k"].shape == (cfg.n_layers, B, 12, cfg.n_kv,
                                       cfg.d_head)
    assert meta["sub0"]["k"].dtype == torch.int8
    assert meta["sub0"]["k_s"].shape == (cfg.n_layers, B, 12, cfg.n_kv, 1)
    params = plm.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab,
                                                                (B, 11)))
    _, caches = plm.prefill(params, tokens[:, :10], max_len=12)
    want, _ = plm.decode_step(params, {"sub0": {k: v.clone() for k, v in
                                                caches["sub0"].items()},
                                       "pos": 10}, tokens[:, 10:])
    quant = {}
    for name in ("k", "v"):
        q, s = PL.quantize_kv(caches["sub0"][name])
        quant[name], quant[name + "_s"] = q, s
    got, _ = plm.decode_step(params, {"sub0": quant, "pos": 10},
                             tokens[:, 10:])
    _bar(got.numpy(), want.numpy())


def test_param_tree_matches_reference_shapes():
    for arch in ARCHS:
        pcfg = preg.get_config(arch, smoke=True)
        ref = RLM(rreg.get_config(arch, smoke=True)).param_meta()
        port = PLM(pcfg).param_meta()
        assert len(port["layers"]) == pcfg.n_layers
        for part in ("mixer", "mlp"):
            for name, m in ref["layers"]["sub0"][part].items():
                assert (pcfg.n_layers,) + port["layers"][0][part][name].shape \
                    == m.shape, (arch, part, name)
        assert ("unembed" in port) == ("unembed" in ref)
        params = pmaterialize(port, torch.Generator().manual_seed(0),
                              dtype=torch.bfloat16)
        assert params["embed"].dtype == torch.bfloat16
        assert bool((params["final_norm"] == 1).all())


@pytest.mark.parametrize("arch", ["mamba2-780m", "llama-3.2-vision-11b",
                                  "whisper-small"])
def test_unported_configs_raise(arch):
    """Every assigned architecture has a config now (the last four came
    with Mamba2, cross-attention and the encoder); a layer kind the port
    does not know is still refused."""
    assert arch in preg.ARCH_NAMES
    assert preg.get_config(arch).name == arch
    PLM(preg.get_config(arch, smoke=True))
    with pytest.raises(NotImplementedError, match="layer kind 'rnn'"):
        PLM(dataclasses.replace(preg.get_config("qwen2.5-3b", smoke=True),
                                pattern=("rnn",)))
