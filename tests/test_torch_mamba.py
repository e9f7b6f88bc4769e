"""The port's Mamba2 against the reference's: ``mamba_apply`` (the chunked
SSD scan, with and without the front pad to whole chunks, one and two
groups) and ``mamba_decode`` (the one-token recurrence) on the reference's
weights in float32 at ``rtol = 1e-4`` and ``atol = 1e-5`` of the largest
value; the port's chunked scan against its own recurrence at the
reference's bars (atol 2e-3, rtol 2e-2, ``tests/test_models.py``); then
the mamba2-780m and jamba-1.5-large-398b smoke models with the
reference's ``LM.init`` weights carried across by
``convert.lm_params_from_jax``: prefill, the state and conv caches and two
decode steps in float32 (jamba at ``capacity_factor = 16``, no drops), and
in bf16 at the reference's teacher-forcing bar (``0.15 * std + 0.05``,
``tests/test_models.py``)."""
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

ARCHS = ["mamba2-780m", "jamba-1.5-large-398b"]
B, STEPS = 2, 2
REC = dict(atol=2e-3, rtol=2e-2)        # tests/test_models.py:95


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _close(got, want, rtol=1e-4, rel_atol=1e-5):
    """float32 parity: rtol 1e-4, atol 1e-5 of the largest |want| (the
    smoke models' random weights give states in the thousands)."""
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel_atol * float(np.abs(want).max()))


def _bar(got, want):
    """The reference's teacher-forcing bar (tests/test_models.py:58)."""
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err < 0.15 * (float(np.std(want)) + 1e-6) + 0.05, err


def _cfg(n_groups=1):
    cfg = preg.get_config("mamba2-780m", smoke=True)
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, n_groups=n_groups))


def _mamba_params(cfg, conv_bias=False):
    """The reference's Mamba2 weights with a_log, dt_bias and d_skip drawn
    away from their constant inits (and the conv bias, if asked)."""
    params = _np_tree(rmaterialize(RL.mamba_meta(cfg), jax.random.key(5),
                                   dtype=jnp.float32))
    rng = np.random.default_rng(6)
    for name in ("a_log", "dt_bias", "d_skip") + (("conv_b",) if conv_bias
                                                  else ()):
        params[name] = (rng.standard_normal(params[name].shape) * 0.5
                        ).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, params),
            {k: torch.from_numpy(v.copy()) for k, v in params.items()})


def _zero_cache(cfg, lib):
    s = cfg.ssm
    conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    shapes = {"state": (B, s.n_heads(cfg.d_model), s.d_state, s.head_dim),
              "conv": (B, s.conv_width - 1, conv_dim)}
    if lib is torch:
        return {k: torch.zeros(v) for k, v in shapes.items()}
    return {k: jnp.zeros(v, jnp.float32) for k, v in shapes.items()}


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("seq", [24, 21, 5])   # whole chunks, front pad, < 1
def test_mamba_apply_matches_reference_at_f32(seq, n_groups):
    cfg = _cfg(n_groups)
    rparams, pparams = _mamba_params(cfg)
    x = (np.random.default_rng(seq).standard_normal((B, seq, cfg.d_model))
         * 0.3).astype(np.float32)
    want, wcache = RL.mamba_apply(rparams, jnp.asarray(x), cfg)
    got, gcache = PL.mamba_apply(pparams, torch.from_numpy(x), cfg)
    assert got.shape == (B, seq, cfg.d_model)
    assert gcache["state"].dtype == torch.float32
    _close(got, want)
    _close(gcache["state"], wcache["state"])
    _close(gcache["conv"], wcache["conv"])


@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba_decode_writes_in_place_and_matches_reference(n_groups):
    cfg = _cfg(n_groups)
    rparams, pparams = _mamba_params(cfg)
    rng = np.random.default_rng(7)
    pcache = _zero_cache(cfg, torch)
    for leaf in pcache.values():
        leaf.copy_(torch.from_numpy(rng.standard_normal(leaf.shape)
                                    .astype(np.float32)))
    rcache = {k: jnp.asarray(v.numpy()) for k, v in pcache.items()}
    state, conv = pcache["state"], pcache["conv"]
    for _ in range(3):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, rcache = RL.mamba_decode(rparams, jnp.asarray(x), rcache, cfg)
        got, pcache = PL.mamba_decode(pparams, torch.from_numpy(x), pcache,
                                      cfg)
        assert pcache["state"] is state and pcache["conv"] is conv
        _close(got, want)
        _close(pcache["state"], rcache["state"])
        _close(pcache["conv"], rcache["conv"])


@pytest.mark.parametrize("conv_bias", [False, True])
@pytest.mark.parametrize("seq", [24, 21])
def test_chunked_scan_equals_the_recurrence(seq, conv_bias):
    """The port's own property at the reference's bars; with a conv bias
    and a front pad too (ROADMAP R11: the reference's pad then adds
    silu(conv_b) inputs and its chunked output leaves its recurrence)."""
    cfg = _cfg()
    _, pparams = _mamba_params(cfg, conv_bias=conv_bias)
    x = torch.from_numpy((np.random.default_rng(seq).standard_normal(
        (B, seq, cfg.d_model)) * 0.3).astype(np.float32))
    full, final = PL.mamba_apply(pparams, x, cfg)
    cache = _zero_cache(cfg, torch)
    outs = [PL.mamba_decode(pparams, x[:, t:t + 1], cache, cfg)[0]
            for t in range(seq)]
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(),
                               **REC)
    np.testing.assert_allclose(final["state"].numpy(),
                               cache["state"].numpy(), **REC)
    np.testing.assert_allclose(final["conv"].numpy(), cache["conv"].numpy(),
                               **REC)


def test_r11_front_pad_with_a_conv_bias_matches_the_reference_recurrence():
    """With a non-zero conv bias and S not a multiple of the chunk, the
    port's chunked scan equals the reference's recurrence (the reference's
    own chunked scan does not: R11)."""
    cfg = _cfg()
    rparams, pparams = _mamba_params(cfg, conv_bias=True)
    x = (np.random.default_rng(11).standard_normal((B, 21, cfg.d_model))
         * 0.3).astype(np.float32)
    cache = _zero_cache(cfg, jnp)
    outs = []
    for t in range(x.shape[1]):
        o, cache = RL.mamba_decode(rparams, jnp.asarray(x[:, t:t + 1]),
                                   cache, cfg)
        outs.append(np.asarray(o))
    got, _ = PL.mamba_apply(pparams, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.concatenate(outs, 1), **REC)


# ---------------------------------------------------------------------------
# The mamba2-780m and jamba smoke models
# ---------------------------------------------------------------------------
def _pair(arch, dtype):
    cfgs = []
    for reg in (rreg, preg):
        cfg = dataclasses.replace(reg.get_config(arch, smoke=True),
                                  dtype=dtype)
        if cfg.moe is not None:                     # no capacity drops
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=16.0))
        cfgs.append(cfg)
    rlm, plm = RLM(cfgs[0]), PLM(cfgs[1])
    params = _np_tree(rlm.init(jax.random.key(0)))
    return (cfgs[1], rlm, plm, jax.tree_util.tree_map(jnp.asarray, params),
            convert.lm_params_from_jax(params, cfgs[1]))


@pytest.fixture(scope="module", params=ARCHS)
def f32_run(request):
    """Prefill of a 21-token prompt (not a multiple of the chunk 8) and two
    decode steps, through both packages."""
    cfg, rlm, plm, rparams, pparams = _pair(request.param, "float32")
    s = 21
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (B, s + STEPS))
    logits, caches = jax.jit(lambda p, t: rlm.prefill(
        p, t, max_len=s + STEPS))(rparams, jnp.asarray(tokens[:, :s]))
    ref = [(np.asarray(logits), _np_tree(caches))]
    step = jax.jit(rlm.decode_step)
    for i in range(STEPS):
        logits, caches = step(rparams, caches,
                              jnp.asarray(tokens[:, s + i:s + i + 1]))
        ref.append((np.asarray(logits), None))
    tok = torch.from_numpy(tokens)
    forward = (np.asarray(rlm.forward(rparams,
                                      jnp.asarray(tokens[:, :s]))[0]),
               plm.forward(pparams, tok[:, :s])[0])
    logits, pc = plm.prefill(pparams, tok[:, :s], max_len=s + STEPS)
    port = [(logits, {k: {n: t.clone() for n, t in v.items()}
                      for k, v in pc.items() if k != "pos"})]
    for i in range(STEPS):
        logits, pc = plm.decode_step(pparams, pc, tok[:, s + i:s + i + 1])
        port.append((logits, None))
    return cfg, ref, port, forward


def test_model_prefill_and_caches_match_at_f32(f32_run):
    cfg, ref, port, _ = f32_run
    _close(port[0][0], ref[0][0])
    caches, rcaches = port[0][1], ref[0][1]
    assert set(caches) == set(rcaches) - {"pos"}
    for sub, leaves in caches.items():
        kind = cfg.layer_kind(int(sub[3:]))
        assert set(leaves) == ({"state", "conv"} if kind == "mamba"
                               else {"k", "v"})
        for name, t in leaves.items():
            assert t.shape == rcaches[sub][name].shape, (sub, name)
            _close(t, rcaches[sub][name])


def test_model_forward_matches_at_f32(f32_run):
    """Every position's logits of the whole forward pass."""
    cfg, _, _, (want, got) = f32_run
    assert got.shape == want.shape
    _close(got[..., :cfg.vocab], want[..., :cfg.vocab])


def test_model_decode_steps_match_at_f32(f32_run):
    _, ref, port, _ = f32_run
    for (got, _), (want, _) in zip(port[1:], ref[1:]):
        _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_the_teacher_forcing_bar(arch):
    """The reference's test_decode_matches_teacher_forcing on the port:
    the bf16 forward against the reference's, and two decode steps after a
    prefill against the port's own forward."""
    cfg, rlm, plm, rparams, pparams = _pair(arch, "bfloat16")
    s = 16
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (B, s))
    want, _ = rlm.forward(rparams, jnp.asarray(tokens))
    tok = torch.from_numpy(tokens)
    full, _ = plm.forward(pparams, tok)
    v = cfg.vocab
    _bar(full.numpy()[..., :v], np.asarray(want)[..., :v])
    _, caches = plm.prefill(pparams, tok[:, :s - 2], max_len=s)
    assert caches["sub0"]["state"].dtype == torch.float32
    assert caches["sub0"]["conv"].dtype == torch.bfloat16
    for t in (s - 2, s - 1):
        step, caches = plm.decode_step(pparams, caches, tok[:, t:t + 1])
        _bar(step.numpy()[:, :v], full[:, t].numpy()[:, :v])
    assert pfa.flash_attention.launches == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_meta_and_param_tree_match_the_reference(arch):
    pcfg = preg.get_config(arch, smoke=True)
    rlm, plm = RLM(rreg.get_config(arch, smoke=True)), PLM(pcfg)
    rmeta, pmeta = rlm.init_cache_meta(3, 20), plm.init_cache_meta(3, 20)
    assert set(pmeta) == set(rmeta)
    for sub, leaves in pmeta.items():
        if sub == "pos":
            continue
        for name, m in leaves.items():
            assert m.shape == rmeta[sub][name].shape, (sub, name)
            assert str(m.dtype).split(".")[-1] == \
                np.dtype(rmeta[sub][name].dtype).name, (sub, name)
    ref = rlm.param_meta()["layers"]
    port = plm.param_meta()["layers"]
    for i, layer in enumerate(port):
        sub = ref[f"sub{i % plm.period}"]
        assert set(layer) == set(sub), i
        for part, tree in layer.items():
            for name, m in tree.items():
                if isinstance(m, dict):      # MoE's shared experts
                    continue
                assert (plm.repeats,) + m.shape == sub[part][name].shape


def test_mamba2_blocks_have_no_mlp():
    """d_ff = 0 builds no MLP (the reference's ``elif cfg.d_ff > 0``)."""
    plm = PLM(preg.get_config("mamba2-780m"))
    assert plm.cfg.d_ff == 0
    assert all(set(layer) == {"mixer"}
               for layer in plm.param_meta()["layers"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_stays_right_when_the_prompt_is_as_long_as_a_cache_axis(arch):
    """A prompt of ``heads`` tokens (axis 2 of the state) or ``W - 1``
    (axis 2 of the conv window): only self-attention leaves grow (ROADMAP
    R10), so the port's decode after ``prefill(max_len=S)`` still meets
    its own teacher forcing."""
    cfg = preg.get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    plm = PLM(cfg)
    params = plm.init(torch.Generator().manual_seed(4))
    nh = cfg.ssm.n_heads(cfg.d_model)
    for prompt in (nh, cfg.ssm.conv_width - 1):
        tok = torch.from_numpy(np.random.default_rng(prompt).integers(
            0, cfg.vocab, (B, prompt + 2)))
        full, _ = plm.forward(params, tok)
        _, caches = plm.prefill(params, tok[:, :prompt], max_len=prompt + 2)
        assert caches["sub0"]["state"].shape[2] == nh
        for t in (prompt, prompt + 1):
            step, caches = plm.decode_step(params, caches, tok[:, t:t + 1])
            _bar(step.numpy()[:, :cfg.vocab],
                 full[:, t].numpy()[:, :cfg.vocab])
