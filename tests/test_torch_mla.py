"""The port's MLA (DeepSeek-V2's latent attention) against the reference's:
``mla_apply`` and ``mla_decode`` on the reference's weights, then the whole
deepseek-v2-lite-16b smoke model (MLA + MoE with a shared expert) with the
reference's ``LM.init`` weights carried across by
``convert.lm_params_from_jax``: prefill, the latent cache and three decode
steps in float32 at ``atol = rtol = 1e-4`` with a prompt of 40 (not a
multiple of ``attention_block = 32``), with ``capacity_factor = 16`` (no
capacity drops, as ``tests/test_models.py`` does for exactness); in bf16
at the reference's MLA bar (``0.5 * std``, ``tests/test_models.py``:
the absorbed-matrix decode reorders the products, and bf16 routing may
pick other experts in the two frameworks)."""
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

ARCH = "deepseek-v2-lite-16b"
B, S, STEPS = 2, 40, 3
TOL = dict(atol=1e-4, rtol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _mla_bar(got, want):
    """The reference's MLA teacher-forcing bar (tests/test_models.py)."""
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err < 0.5 * (float(np.std(want)) + 1e-6), err


def _cfgs(dtype, capacity_factor=16.0):
    out = []
    for reg in (rreg, preg):
        cfg = reg.get_config(ARCH, smoke=True)
        out.append(dataclasses.replace(
            cfg, dtype=dtype, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor)))
    return out


def _pair(dtype):
    rcfg, pcfg = _cfgs(dtype)
    rlm, plm = RLM(rcfg), PLM(pcfg)
    params = _np_tree(rlm.init(jax.random.key(0)))
    return (rcfg, pcfg, rlm, plm, jax.tree_util.tree_map(jnp.asarray, params),
            convert.lm_params_from_jax(params, pcfg))


def _mla_params():
    cfg = preg.get_config(ARCH, smoke=True)
    params_np = _np_tree(rmaterialize(RL.mla_meta(cfg), jax.random.key(7),
                                      dtype=jnp.float32))
    params_np["kv_norm"] = (1 + 0.1 * np.random.default_rng(8)
                            .standard_normal(params_np["kv_norm"].shape)
                            ).astype(np.float32)
    return (cfg, jax.tree_util.tree_map(jnp.asarray, params_np),
            {k: torch.from_numpy(v.copy()) for k, v in params_np.items()})


def test_mla_apply_matches_reference_at_f32():
    cfg, rparams, pparams = _mla_params()
    x = (np.random.default_rng(9).standard_normal((B, S, cfg.d_model))
         ).astype(np.float32)
    want, (rc, rk) = RL.mla_apply(rparams, jnp.asarray(x), cfg)
    got, (pc, pk) = PL.mla_apply(pparams, torch.from_numpy(x), cfg)
    m = cfg.mla
    assert got.shape == (B, S, cfg.d_model)
    assert pc.shape == (B, S, m.kv_lora) and pk.shape == (B, S, m.d_rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), **TOL)
    np.testing.assert_allclose(pk.numpy(), np.asarray(rk), **TOL)


def test_mla_decode_writes_the_slot_in_place_and_matches_reference():
    cfg, rparams, pparams = _mla_params()
    m = cfg.mla
    rng = np.random.default_rng(10)
    max_len, pos = 24, 17
    ckv = rng.standard_normal((B, max_len, m.kv_lora)).astype(np.float32)
    kr = rng.standard_normal((B, max_len, m.d_rope)).astype(np.float32)
    rcache = {"ckv": jnp.asarray(ckv), "kr": jnp.asarray(kr),
              "pos": jnp.asarray(pos, jnp.int32)}
    pcache = {"ckv": torch.from_numpy(ckv.copy()),
              "kr": torch.from_numpy(kr.copy()), "pos": pos}
    for step in range(STEPS):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, rcache = RL.mla_decode(rparams, jnp.asarray(x), rcache, cfg)
        ckv_t = pcache["ckv"]
        got, pcache = PL.mla_decode(pparams, torch.from_numpy(x), pcache,
                                    cfg)
        assert pcache["ckv"] is ckv_t and pcache["pos"] == pos + step + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in ("ckv", "kr"):
            np.testing.assert_allclose(pcache[name].numpy(),
                                       np.asarray(rcache[name]), **TOL)


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


@pytest.fixture(scope="module")
def f32_run():
    rcfg, pcfg, rlm, plm, rparams, pparams = _pair("float32")
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab, size=(B, S + STEPS)).astype(np.int32)
    return (_run_reference(rlm, rparams, tokens),
            _run_port(plm, pparams, tokens), pcfg)


def test_prefill_logits_and_latent_cache_match_at_f32(f32_run):
    (rlog, rcache), (plog, pcache), cfg = f32_run
    m = cfg.mla
    assert plog[0].shape == (B, cfg.vocab_padded)
    np.testing.assert_allclose(plog[0].numpy(), rlog[0], **TOL)
    assert set(pcache) == set(rcache["sub0"]) == {"ckv", "kr"}
    for name, width in (("ckv", m.kv_lora), ("kr", m.d_rope)):
        got, want = pcache[name].numpy(), rcache["sub0"][name]
        assert got.shape == want.shape == (cfg.n_layers, B, S + STEPS, width)
        np.testing.assert_allclose(got, want, **TOL)
    assert int(rcache["pos"]) == S


def test_decode_steps_match_at_f32_with_equal_greedy_tokens(f32_run):
    (rlog, _), (plog, _), _ = f32_run
    for want, got in zip(rlog[1:], plog[1:]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      want.argmax(-1))


def test_latent_caches_carry_across_and_decode_on():
    """A JAX prefill's latent cache, converted, decodes in the port to the
    reference's own decode step."""
    rcfg, _, rlm, plm, rparams, pparams = _pair("float32")
    tokens = np.random.default_rng(3).integers(0, rcfg.vocab, (B, S + 1))
    _, caches = rlm.prefill(rparams, jnp.asarray(tokens[:, :S]),
                            max_len=S + 1)
    want, _ = rlm.decode_step(rparams, caches, jnp.asarray(tokens[:, S:]))
    got, new = plm.decode_step(pparams,
                               convert.lm_caches_from_jax(_np_tree(caches)),
                               torch.from_numpy(tokens[:, S:]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert new["pos"] == S + 1 and set(new["sub0"]) == {"ckv", "kr"}


def _near_ties(monkeypatch, cfg):
    """Record, while the port runs, which tokens any MoE layer routes on a
    near tie: the k-th and (k+1)-th router logits (bf16 products, whose
    ulp is 2^-10 at 0.25..0.5) within 2^-9, where the two frameworks'
    bf16 rounding may pick either expert.  Returns the (B, S) mask, filled
    as the layers run."""
    k = cfg.moe.top_k
    ties = np.zeros((B, S), bool)
    route = PL.moe_route

    def recording(params, x, cfg):
        out = route(params, x, cfg)
        top = torch.topk(out[1], k + 1, dim=-1).values.log()
        near = (top[:, k - 1] - top[:, k]) < 2.0 ** -9
        ties[...] |= near.reshape(x.shape[:2]).numpy()
        return out
    monkeypatch.setattr(PL, "moe_route", recording)
    return ties


def test_bf16_within_the_mla_bar(monkeypatch):
    rcfg, pcfg, rlm, plm, rparams, pparams = _pair("bfloat16")
    tokens = np.random.default_rng(4).integers(0, rcfg.vocab, (B, S))
    want, _ = rlm.forward(rparams, jnp.asarray(tokens))
    ties = _near_ties(monkeypatch, pcfg)
    got, _ = plm.forward(pparams, torch.from_numpy(tokens).long())
    monkeypatch.undo()
    assert got.dtype == torch.float32
    v = rcfg.vocab
    # every token but those routed on a near tie (token (1, 31) here, whose
    # second layer's second and third logits differ by one ulp, goes to
    # another expert in the reference)
    assert ties[1, 31] and ties.mean() <= 0.1
    _mla_bar(got.numpy()[~ties][:, :v],
             np.asarray(want, np.float32)[~ties][:, :v])
    # the port's own absorbed-matrix decode against its own teacher forcing
    _, caches = plm.prefill(pparams, torch.from_numpy(tokens[:, :S - 1]),
                            max_len=S)
    assert caches["sub0"]["ckv"].dtype == torch.bfloat16
    step, _ = plm.decode_step(pparams, caches,
                              torch.from_numpy(tokens[:, S - 1:]))
    _mla_bar(step.numpy()[:, :v], got[:, S - 1].numpy()[:, :v])
    assert pfa.flash_attention.launches == 0


def test_cache_meta_matches_the_reference_and_ignores_kv_dtype():
    for dtype in ("float32", "bfloat16"):
        rcfg, pcfg = _cfgs(dtype)
        want = RLM(rcfg).init_cache_meta(B, 12)
        plm = PLM(pcfg)
        plm.kv_cache_dtype = torch.int8            # not for MLA
        got = plm.init_cache_meta(B, 12)
        assert set(got) == set(want) == {"sub0", "pos"}
        for name, m in want["sub0"].items():
            assert got["sub0"][name].shape == m.shape, name
            assert got["sub0"][name].dtype == getattr(torch, dtype)
        assert set(got["sub0"]) == {"ckv", "kr"}


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-30b-a3b"])
def test_param_tree_matches_reference_shapes(arch):
    pcfg = preg.get_config(arch, smoke=True)
    ref = RLM(rreg.get_config(arch, smoke=True)).param_meta()
    port = PLM(pcfg).param_meta()
    assert len(port["layers"]) == pcfg.n_layers

    def walk(r, p, where):
        assert set(r) == set(p), where
        for name, m in r.items():
            if isinstance(m, dict):
                walk(m, p[name], f"{where}/{name}")
            else:
                assert (pcfg.n_layers,) + p[name].shape == m.shape, \
                    (where, name)
                assert p[name].init == m.init and p[name].scale == m.scale
    for part in ("mixer", "mlp"):
        walk(ref["layers"]["sub0"][part], port["layers"][0][part], part)
    assert ("shared" in port["layers"][0]["mlp"]) == (arch == ARCH)
    assert ("unembed" in port) == ("unembed" in ref)
