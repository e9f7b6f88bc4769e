"""``LM.loss`` and every leaf of its gradient against
``jax.value_and_grad`` of the reference's ``LM.loss`` on all ten smoke
configs, in float32 with MoE at ``capacity_factor = 16`` (no drops), the
reference's ``LM.init`` weights carried across by
``convert.lm_params_from_jax`` (its gradient tree the same way): loss,
nll and aux at rtol 1e-4; each gradient leaf at rtol 1e-4 with an atol of
``ATOL[arch]`` x that leaf's largest value.  Also the port's gradients
with and without the per-layer recomputation, bit for bit.

``ATOL`` is 1e-5 where a config reaches it (mamba2-780m).  The others need
more, and not because the port differs from the reference: the random
smoke models are badly conditioned in float32.  Against a float64 run of
the port on the same weights, the reference's float32 gradients are off by
up to 5.6e-5 (qwen2.5-3b) and 2.7e-3 (llama-3.2-vision-11b, its
cross-attention over 0.5 N(0, 1) embeddings) of a leaf's largest value,
and the port's by the same order.  The port-to-reference gaps measured on
these inputs are 4.3e-5 (the dense GQA four), 7.9e-5 (qwen3-moe),
2.1e-4 (deepseek, MLA), 1.4e-4 (jamba), 1.0e-3 (whisper) and 2.0e-3
(llama-vision); each bar is about 2.5x its config's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models.lm import LM as RLM
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import registry as preg
from repro_torch.launch import steps as psteps
from repro_torch.models import lm as plm_module
from repro_torch.models.lm import LM as PLM

B, S = 2, 32
ATOL = {"qwen2.5-3b": 1e-4, "granite-8b": 1e-4, "qwen2-7b": 1e-4,
        "yi-34b": 1e-4, "mamba2-780m": 1e-5, "llama-3.2-vision-11b": 5e-3,
        "qwen3-moe-30b-a3b": 2e-4, "deepseek-v2-lite-16b": 5e-4,
        "whisper-small": 3e-3, "jamba-1.5-large-398b": 4e-4}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _cfgs(arch):
    out = []
    for reg in (rreg, preg):
        cfg = dataclasses.replace(reg.get_config(arch, smoke=True),
                                  dtype="float32")
        if cfg.moe is not None:                     # no capacity drops
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=16.0))
        out.append(cfg)
    return out


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.aux_seq:
        batch["aux"] = (0.5 * rng.standard_normal(
            (B, cfg.aux_seq, cfg.d_model))).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def setup(arch):
    rcfg, pcfg = _cfgs(arch)
    rlm, plm = RLM(rcfg), PLM(pcfg)
    params = _np_tree(rlm.init(jax.random.key(0)))
    return (rcfg, pcfg, rlm, plm, params,
            convert.lm_params_from_jax(params, pcfg))


@pytest.mark.parametrize("arch", list(rreg.ARCH_NAMES))
def test_loss_and_every_gradient_leaf_match_jax(arch):
    rcfg, pcfg, rlm, plm, params, pparams = setup(arch)
    batch = _batch(rcfg)
    (rloss, rex), rgrads = jax.value_and_grad(rlm.loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    (ploss, pex), pgrads = psteps.value_and_grad(plm, pparams,
                                                 _torch_batch(batch))
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-4)
    for name in ("nll", "aux_loss"):
        np.testing.assert_allclose(float(pex[name]), float(rex[name]),
                                   rtol=1e-4, atol=1e-7)
    want = dict(T.leaves_with_paths(
        convert.lm_params_from_jax(_np_tree(rgrads), pcfg)))
    got = dict(T.leaves_with_paths(pgrads))
    assert set(got) == set(want) and len(got) > 5
    for path, g in got.items():
        w = want[path].numpy()
        assert g.shape == w.shape and g.dtype == torch.float32, path
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4,
            atol=ATOL[arch] * float(np.abs(w).max()) + 1e-30, err_msg=path)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "jamba-1.5-large-398b",
                                  "whisper-small"])
def test_gradients_with_and_without_remat_are_equal_bit_for_bit(
        arch, monkeypatch):
    _, pcfg, _, plm, _, pparams = setup(arch)
    batch = _torch_batch(_batch(pcfg, seed=2))
    calls = []
    real = plm_module.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)
    monkeypatch.setattr(plm_module, "checkpoint", counted)
    (l1, _), g1 = psteps.value_and_grad(plm, pparams, batch)
    assert len(calls) == pcfg.n_layers
    monkeypatch.setattr(plm_module, "checkpoint",
                        lambda fn, *args, **kw: fn(*args))
    (l2, _), g2 = psteps.value_and_grad(plm, pparams, batch)
    assert torch.equal(l1, l2)
    for a, b in zip(T.leaves(g1), T.leaves(g2)):
        assert torch.equal(a, b)
