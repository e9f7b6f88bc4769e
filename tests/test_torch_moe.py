"""The port's MoE against the reference's: ``moe_apply`` on the reference's
weights in float32 at rtol 1e-5, with the chosen experts and the kept mask
equal exactly, without capacity drops (``capacity_factor = 16``) and at
``capacity_factor = 1.0`` (the buffer's spare row ``E * cap`` is then the
reference's drop slot ``t * top_k`` too, so drops land on it in both);
the colliding case of ROADMAP R9 (``E * cap > t * top_k``, where the
reference's drop slot is a kept token's) against an independent per-token
numpy reference; ``moe_aux_loss``; and the whole qwen3-moe-30b-a3b smoke
model (GQA + MoE) and a GQA model with MoE every second layer (a period of
2: the caches' ``sub0``/``sub1``) against ``repro.models.lm.LM``, prefill,
decode and the auxiliary loss, with ``capacity_factor = 16``."""
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
from repro_torch.models import layers as PL
from repro_torch.models.lm import LM as PLM

RTOL = 1e-5
ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"]


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _cfg(arch, cf, reg=preg, **kw):
    cfg = reg.get_config(arch, smoke=True)
    return dataclasses.replace(
        cfg, dtype="float32", **kw,
        moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _case(arch, cf, *, router_scale=1.0, b=2, s=24, seed=0):
    """(config, reference params, port params, x as numpy) for one MoE
    layer in float32."""
    cfg = _cfg(arch, cf)
    params_np = _np_tree(rmaterialize(RL.moe_meta(cfg),
                                      jax.random.key(seed),
                                      dtype=jnp.float32))
    params_np["router"] = params_np["router"] * np.float32(router_scale)
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    port = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                  params_np)
    return cfg, jax.tree_util.tree_map(jnp.asarray, params_np), port, x


def _reference_routing(rparams, x, cfg):
    """The reference's experts and kept mask, from its own primitives
    (``moe_apply``'s routing, in ``(T, k)`` order)."""
    e = cfg.moe
    t = x.shape[0] * x.shape[1]
    xn = RL.rmsnorm(jnp.asarray(x), rparams["norm"], cfg.norm_eps)
    logits = (xn.reshape(t, -1) @ rparams["router"]).astype(jnp.float32)
    _, expert = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), e.top_k)
    expert = np.asarray(expert)
    flat = expert.reshape(-1)
    order = np.argsort(flat, kind="stable")
    starts = np.searchsorted(flat[order], np.arange(e.n_experts))
    pos = np.empty_like(flat)
    pos[order] = np.arange(flat.size) - starts[flat[order]]
    cap = max(8, int(t * e.top_k / e.n_experts * e.capacity_factor))
    if cap >= 128:
        cap = -(-cap // 128) * 128
    return expert, (pos < cap).reshape(expert.shape), cap


def _port_routing(pparams, x, cfg):
    _, _, _, expert = PL.moe_route(pparams, torch.from_numpy(x), cfg)
    order, keep, _, cap = PL.moe_dispatch(expert, cfg)
    kept = torch.empty_like(keep)
    kept[order] = keep
    return expert.numpy(), kept.view(expert.shape).numpy(), cap


def _numpy_moe(params, x, cfg):
    """An independent per-token MoE in float64: each token's top-k experts,
    an expert keeping its first ``cap`` tokens in token order, the kept
    experts' gated outputs summed, plus the shared experts."""
    e = cfg.moe
    p = {k: np.asarray(v, np.float64) for k, v in params.items()
         if k != "shared"}
    xf = x.reshape(-1, x.shape[-1]).astype(np.float64)
    xn = xf / np.sqrt((xf * xf).mean(-1, keepdims=True) + cfg.norm_eps)
    xn = xn * p["norm"]
    logits = xn @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    expert = np.argsort(-probs, axis=-1, kind="stable")[:, :e.top_k]
    gate = np.take_along_axis(probs, expert, -1)
    gate /= gate.sum(-1, keepdims=True)
    t = xf.shape[0]
    cap = max(8, int(t * e.top_k / e.n_experts * e.capacity_factor))
    if cap >= 128:
        cap = -(-cap // 128) * 128

    def silu(a):
        return a / (1 + np.exp(-a))
    filled = np.zeros(e.n_experts, int)
    y = np.zeros_like(xf)
    for i in range(t):
        for j, ex in enumerate(expert[i]):
            if filled[ex] < cap:
                h = silu(xn[i] @ p["wg"][ex]) * (xn[i] @ p["wu"][ex])
                y[i] += gate[i, j] * (h @ p["wd"][ex])
            filled[ex] += 1
    if "shared" in params:
        sh = {k: np.asarray(v, np.float64)
              for k, v in params["shared"].items()}
        y += (silu(xn @ sh["wg"]) * (xn @ sh["wu"])) @ sh["wd"]
    return y.reshape(x.shape), expert, filled


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [16.0, 1.0])
def test_moe_apply_matches_reference_at_f32(arch, cf):
    # the router scaled up so that cf = 1.0 drops assignments
    cfg, rparams, pparams, x = _case(arch, cf, router_scale=20.0)
    want = np.asarray(RL.moe_apply(rparams, jnp.asarray(x), cfg))
    got = PL.moe_apply(pparams, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    r_exp, r_keep, r_cap = _reference_routing(rparams, x, cfg)
    p_exp, p_keep, p_cap = _port_routing(pparams, x, cfg)
    np.testing.assert_array_equal(p_exp, r_exp)
    np.testing.assert_array_equal(p_keep, r_keep)
    assert p_cap == r_cap
    t = x.shape[0] * x.shape[1]
    if cf == 1.0:
        # the spare row is the reference's drop slot, and drops happen
        assert cfg.moe.n_experts * p_cap == t * cfg.moe.top_k
        assert not p_keep.all()
    else:
        assert p_keep.all()


def test_r9_colliding_drops_match_a_per_token_reference():
    """ROADMAP R9: at cf = 1.25, E * cap = 320 > t * top_k = 256, so the
    reference's drop slot 256 (expert 6, position 16) is a kept token's.
    The port sends drops to the spare row 320 and equals the per-token
    numpy reference for every token; the reference's scatter overwrites the
    kept token's input row with a dropped one's."""
    cfg, rparams, pparams, x = _case("qwen3-moe-30b-a3b", 1.25,
                                     router_scale=40.0, b=2, s=64, seed=3)
    e = cfg.moe
    t = x.shape[0] * x.shape[1]
    want, expert, filled = _numpy_moe(
        jax.tree_util.tree_map(np.asarray, rparams), x, cfg)
    cap = PL.moe_capacity(cfg, t)
    assert (cap, e.n_experts * cap, t * e.top_k) == (40, 320, 256)
    assert (filled > cap).any()                    # some assignments drop
    got = PL.moe_apply(pparams, torch.from_numpy(x), cfg).numpy()
    p_exp, _, _ = _port_routing(pparams, x, cfg)
    np.testing.assert_array_equal(p_exp, expert)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)
    # the token holding slot t * top_k = expert 6's 17th place
    holder = np.flatnonzero((expert == 6).any(-1))[16]
    ref = np.asarray(RL.moe_apply(rparams, jnp.asarray(x), cfg))
    ref_err = np.abs(ref - want).reshape(t, -1).max(-1)
    assert ref_err[holder] > 1e3 * RTOL * scale
    assert np.delete(ref_err, holder).max() <= RTOL * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_matches_reference(arch):
    cfg, rparams, pparams, x = _case(arch, 1.25, router_scale=5.0)
    want = float(RL.moe_aux_loss(rparams, jnp.asarray(x), cfg))
    got = PL.moe_aux_loss(pparams, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    assert want > 1.0          # skewed routing: above the balanced 1.0


@pytest.mark.parametrize("t,cap", [(4, 8), (100, 11), (1000, 117),
                                   (1100, 128), (2048, 256), (8192, 1024)])
def test_capacity_is_the_reference_arithmetic(t, cap):
    """Capacity for t tokens at cf 1.25 (top-k 6 of 64 experts,
    deepseek-v2-lite-16b): int(t * 6 / 64 * 1.25), at least 8, rounded up
    to a multiple of 128 from 128 on (1024 at the full-width prefill)."""
    cfg = preg.get_config("deepseek-v2-lite-16b")
    assert PL.moe_capacity(cfg, t) == cap


def test_combine_is_in_ascending_expert_order():
    """Each token's gated expert outputs are summed in ascending expert id
    (the reference's scatter-add order), whatever order top-k gives them:
    in bf16 the sum matches that order bit for bit."""
    cfg, _, pparams, x = _case("qwen3-moe-30b-a3b", 16.0, router_scale=5.0)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    pb = jax.tree_util.tree_map(lambda a: a.to(torch.bfloat16), pparams)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = PL.moe_apply(pb, xb, cfg)
    xf, _, gate, expert = PL.moe_route(pb, xb, cfg)
    want = torch.zeros_like(xf)
    for i in range(xf.shape[0]):
        for j in torch.argsort(expert[i]).tolist():
            ex = int(expert[i, j])
            h = torch.nn.functional.silu(xf[i] @ pb["wg"][ex]) \
                * (xf[i] @ pb["wu"][ex])
            want[i] = want[i] + gate[i, j].to(xb.dtype) * (h @ pb["wd"][ex])
    assert torch.equal(got.reshape(want.shape), want)
    assert torch.equal(PL.moe_apply(pb, xb, cfg), got)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
B, S, STEPS = 2, 40, 3


def _close(got, want):
    """``test_torch_lm.py``'s 1e-4, the absolute part scaled by the
    tensor's largest magnitude: at the smoke init an MoE layer adds ~10x
    the residual, so later layers' K/V and logits run to ~10."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def _every2(reg):
    """qwen3-moe's smoke widths with 4 layers and MoE on every second one:
    the reference stacks it as a period of 2."""
    cfg = _cfg("qwen3-moe-30b-a3b", 16.0, reg=reg, n_layers=4)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            every=2))


def _models(name):
    if name == "every2":
        return _every2(rreg), _every2(preg)
    return _cfg(name, 16.0, reg=rreg), _cfg(name, 16.0)


@pytest.fixture(scope="module", params=["qwen3-moe-30b-a3b", "every2"])
def model_run(request):
    rcfg, pcfg = _models(request.param)
    rlm, plm = RLM(rcfg), PLM(pcfg)
    params = _np_tree(rlm.init(jax.random.key(0)))
    rparams = jax.tree_util.tree_map(jnp.asarray, params)
    pparams = convert.lm_params_from_jax(params, pcfg)
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab, size=(B, S + STEPS)).astype(np.int32)
    rlog, rc = rlm.prefill(rparams, jnp.asarray(tokens[:, :S]),
                           max_len=S + STEPS)
    tok = torch.from_numpy(tokens).long()
    plog, pc = plm.prefill(pparams, tok[:, :S], max_len=S + STEPS)
    first = (_np_tree(rc), {k: {n: t.clone() for n, t in v.items()}
                            for k, v in pc.items() if k != "pos"})
    steps = []
    for i in range(STEPS):
        rlog_i, rc = rlm.decode_step(rparams, rc,
                                     jnp.asarray(tokens[:, S + i:S + i + 1]))
        plog_i, pc = plm.decode_step(pparams, pc, tok[:, S + i:S + i + 1])
        steps.append((np.asarray(rlog_i), plog_i.numpy()))
    aux = (float(rlm.forward(rparams, jnp.asarray(tokens))[1]),
           float(plm.forward(pparams, tok)[1]))
    return dict(cfg=pcfg, prefill=(np.asarray(rlog), plog.numpy()),
                caches=first, steps=steps, aux=aux, plm=plm)


def test_model_prefill_and_caches_match_at_f32(model_run):
    want, got = model_run["prefill"]
    _close(got, want)
    rc, pc = model_run["caches"]
    period = model_run["plm"].period
    assert set(pc) == {f"sub{j}" for j in range(period)}
    assert set(rc) == set(pc) | {"pos"}
    for sub, leaves in pc.items():
        for name, t in leaves.items():
            assert t.shape == rc[sub][name].shape
            _close(t.numpy(), rc[sub][name])


def test_model_decode_steps_match_at_f32(model_run):
    for want, got in model_run["steps"]:
        _close(got, want)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_forward_aux_loss_is_the_sum_over_moe_layers(model_run):
    want, got = model_run["aux"]
    cfg = model_run["cfg"]
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert n_moe == (2 if cfg.moe.every == 2 else cfg.n_layers)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got > 0.9 * n_moe          # each term is at least about 1


def test_deepseek_forward_aux_loss_matches_reference():
    rcfg, pcfg = _cfg("deepseek-v2-lite-16b", 16.0, reg=rreg), \
        _cfg("deepseek-v2-lite-16b", 16.0)
    rlm, plm = RLM(rcfg), PLM(pcfg)
    params = _np_tree(rlm.init(jax.random.key(5)))
    tokens = np.random.default_rng(6).integers(0, rcfg.vocab, (B, S))
    want = float(rlm.forward(jax.tree_util.tree_map(jnp.asarray, params),
                             jnp.asarray(tokens))[1])
    got = plm.forward(convert.lm_params_from_jax(params, pcfg),
                      torch.from_numpy(tokens).long())[1]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


def test_router_ties_go_to_the_lower_expert_id():
    """Equal router probabilities (two identical router columns, as bf16
    logits often are at full width) choose the lower expert id first, as
    ``jax.lax.top_k`` does."""
    cfg, rparams, pparams, x = _case("qwen3-moe-30b-a3b", 16.0,
                                     router_scale=5.0)
    router = np.asarray(rparams["router"]).copy()
    _, r_exp, _ = _reference_routing(rparams, x, cfg)
    # copy each token's first choice onto a lower and a higher expert id
    top = int(np.bincount(r_exp[:, 0]).argmax())
    for twin in (top - 1, top + 1):
        if 0 <= twin < cfg.moe.n_experts:
            router[:, twin] = router[:, top]
    rparams = dict(rparams, router=jnp.asarray(router))
    pparams = dict(pparams, router=torch.from_numpy(router))
    r_exp, r_keep, _ = _reference_routing(rparams, x, cfg)
    p_exp, p_keep, _ = _port_routing(pparams, x, cfg)
    assert (r_exp[:, 0] == r_exp[:, 0].min()).any()
    np.testing.assert_array_equal(p_exp, r_exp)
    np.testing.assert_array_equal(p_keep, r_keep)
