"""The port's train path (``launch/steps.py``, ``launch/train.py``)
against the reference's: one ``make_train_step`` at microbatches 1 and 2
from the same float32 weights and AdamW state (carried across by
``convert.lm_params_from_jax`` and ``adamw_state_from_jax``, the state
after one reference step, so the moments are not zero), at the gradient
bar of ``test_torch_train_grads.py``; ``run`` on the CPU (the loss falls
over 30 smoke steps; R12: a run with a fault at step 7 and a checkpoint
every 4 steps ends with the weights of an uninterrupted run, bit for bit);
``train_traffic_bytes`` against a hand count; ``PowerMonitor.report``
against the reference's ``hbm.step_energy`` at the same byte counts and
statistics; the CLI and its refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hbm as rhbm
from repro.core.vampire import reference_vampire as r_reference_vampire
from repro.launch import steps as rsteps
from repro.optim import adamw as radamw
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.core import hbm as phbm
from repro_torch.launch import steps as psteps
from repro_torch.launch import train as ptrain
from repro_torch.optim import adamw as padamw

from test_torch_train_grads import _batch, _np_tree, _torch_batch, setup

ARCH = "qwen2.5-3b"
BAR = 1e-4        # the qwen2.5-3b gradient bar of test_torch_train_grads


def _close_tree(got, want_np, cfg, what, atol=None):
    """Every leaf at rtol 1e-4 with ``atol`` (default: the moments' bar,
    2e-3 of the leaf's largest value)."""
    want = dict(T.leaves_with_paths(convert.lm_params_from_jax(want_np,
                                                               cfg)))
    for path, g in T.leaves_with_paths(got):
        w = want[path].numpy()
        bar = 2e-3 * float(np.abs(w).max()) if atol is None else atol
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=bar,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_train_step_matches_the_reference(microbatches):
    rcfg, pcfg, rlm, plm, params, _ = setup(ARCH)
    ocfg_kw = dict(warmup_steps=2, decay_steps=10, lr=1e-3)
    rocfg = radamw.AdamWConfig(**ocfg_kw)
    pocfg = padamw.AdamWConfig(**ocfg_kw)
    jbatch = {k: jnp.asarray(v) for k, v in _batch(rcfg).items()}
    rstep = rsteps.make_train_step(rlm, rocfg, microbatches=microbatches)
    rparams = jax.tree_util.tree_map(jnp.asarray, params)
    # one reference step first: the state the compared step starts from
    rparams, rstate, _ = rstep(rparams, radamw.init(rparams, rocfg), jbatch)
    pparams = convert.lm_params_from_jax(_np_tree(rparams), pcfg)
    pstate = convert.adamw_state_from_jax(_np_tree(rstate), pcfg)
    assert int(pstate["step"]) == 1
    batch2 = _batch(rcfg, seed=5)
    rparams, rstate, rmet = rstep(rparams, rstate,
                                  {k: jnp.asarray(v)
                                   for k, v in batch2.items()})
    pstep = psteps.make_train_step(plm, pocfg, microbatches=microbatches)
    pparams, pstate, pmet = pstep(pparams, pstate, _torch_batch(batch2))
    # the gradient norm of gradients that agree at BAR (float32
    # conditioning, test_torch_train_grads): rtol 3 BAR
    for name, rtol in (("loss", 1e-4), ("nll", 1e-4), ("aux_loss", 1e-4),
                       ("lr", 1e-6), ("grad_norm", 3 * BAR)):
        np.testing.assert_allclose(float(pmet[name]), float(rmet[name]),
                                   rtol=rtol, atol=1e-7, err_msg=name)
    # Adam divides each element's first moment by the root of its second,
    # so an element whose gradient is small beside its leaf's largest
    # carries the gradient's gap (BAR of the leaf's largest) into its
    # update whole: the weights are held to 0.05 of the step's learning
    # rate (measured 0.0102 and 0.0074 at microbatches 1 and 2), the moments
    # to 2e-3 of each leaf's largest value (measured 4.1e-4 and 6.3e-5)
    _close_tree(pparams, _np_tree(rparams), pcfg, "params",
                atol=0.05 * float(rmet["lr"]))
    for name in ("m", "v"):
        _close_tree(pstate[name], _np_tree(rstate[name]), pcfg, name)
    assert int(pstate["step"]) == int(rstate["step"]) == 2


def test_int8_moments_carry_across():
    rcfg, pcfg, rlm, _, params, pparams = setup(ARCH)
    ocfg = radamw.AdamWConfig(quantize_moments=True)
    state = radamw.init(jax.tree_util.tree_map(jnp.asarray, params), ocfg)
    state = {"m": state["m"], "v": state["v"], "step": jnp.asarray(3)}
    pstate = convert.adamw_state_from_jax(_np_tree(state), pcfg)
    want = padamw.init(pparams, padamw.AdamWConfig(quantize_moments=True))
    assert int(pstate["step"]) == 3
    got_leaves = T.leaves_with_paths(pstate["m"])
    want_leaves = dict(T.leaves_with_paths(want["m"]))
    assert len(got_leaves) == len(want_leaves)
    for path, t in got_leaves:
        assert t.dtype == want_leaves[path].dtype
        assert t.shape == want_leaves[path].shape, path


def test_loss_decreases_over_thirty_smoke_steps():
    res = ptrain.run(ptrain.TrainJob(arch=ARCH, smoke=True, steps=30,
                                     batch=4, seq=64, power_every=0,
                                     device="cpu"))
    assert res["steps_run"] == 30 and np.all(np.isfinite(res["losses"]))
    assert np.mean(res["losses"][-5:]) < np.mean(res["losses"][:5]) - 0.1


def test_r12_a_restored_run_equals_an_uninterrupted_one(tmp_path):
    """ROADMAP R12: the reference reruns the checkpointed step after a
    restore; the port labels a checkpoint with the next step to run, so
    the interrupted run ends with the uninterrupted run's weights and
    moments, bit for bit."""
    kw = dict(arch=ARCH, smoke=True, steps=12, batch=2, seq=32,
              ckpt_every=4, power_every=0, device="cpu")
    clean = ptrain.run(ptrain.TrainJob(**kw))
    hit = ptrain.run(ptrain.TrainJob(ckpt_dir=str(tmp_path), fail_at=(7,),
                                     **kw))
    assert hit["recoveries"] == 1
    # the fault at step 7 restores the label-4 checkpoint: 4, 5, 6 rerun
    assert hit["steps_run"] == 15 and clean["steps_run"] == 12
    assert hit["losses"][4:7] == hit["losses"][7:10] == clean["losses"][4:7]
    for a, b in zip(T.leaves(clean["params"]) + T.leaves(clean["opt_state"]),
                    T.leaves(hit["params"]) + T.leaves(hit["opt_state"])):
        assert torch.equal(a, b)
    # a fresh job on the same directory resumes at the final label
    again = ptrain.run(ptrain.TrainJob(ckpt_dir=str(tmp_path), **kw))
    assert again["steps_run"] == 0


def test_train_traffic_bytes_equals_a_hand_count():
    _, pcfg, _, plm, _, pparams = setup(ARCH)
    state = padamw.init(pparams, padamw.AdamWConfig())
    n_params = sum(int(np.prod(m.shape)) for m in T.leaves(
        plm.param_meta(), is_leaf=lambda x: hasattr(x, "init")))
    tokens = 4 * 64
    w = 4 * n_params                     # float32 weights and gradients
    moments = 2 * 4 * n_params
    saved = pcfg.n_layers * tokens * pcfg.d_model * 4
    logits = tokens * pcfg.vocab_padded * 4
    want = (3 * w) + (w + w) + 2 * moments + 2 * w + 2 * saved + 4 * logits
    assert ptrain.train_traffic_bytes(plm, pparams, state, tokens) == want


def test_power_report_equals_the_reference_step_energy():
    """The same HBM model (the reference's quick fit carried across), the
    same byte counts and the same leaf's statistics give the reference's
    ``hbm.step_energy``."""
    _, pcfg, _, plm, params, pparams = setup(ARCH)
    pp = r_reference_vampire().params(0)
    leaves = {name: np.asarray(getattr(pp, name)) for name in pp._fields}
    ppp = convert.power_params_from_numpy(leaves)
    rmodel = rhbm.HbmEnergyModel.from_vampire(pp)
    pmodel = phbm.HbmEnergyModel.from_vampire(ppp)
    state = padamw.init(pparams, padamw.AdamWConfig())
    traffic = ptrain.train_traffic_bytes(plm, pparams, state, 256)
    mon = ptrain.PowerMonitor(traffic, model=pmodel)
    got = mon.report(pparams, 0.25)
    big = max((x for x in T.leaves(pparams)), key=lambda x: x.numel())
    sample = jnp.asarray(big.reshape(-1)[:65536].numpy())
    ones, togg = rhbm.tensor_stats(sample)
    want = rhbm.step_energy(rmodel, read_bytes=0.6 * traffic,
                            write_bytes=0.4 * traffic, step_seconds=0.25,
                            ones_frac=ones, toggle_frac=togg)
    np.testing.assert_allclose(got.ones_frac, float(ones), rtol=1e-7)
    np.testing.assert_allclose(got.toggle_frac, float(togg), rtol=1e-7)
    for name in ("read_bytes", "write_bytes", "read_pj", "write_pj",
                 "static_pj", "total_pj"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, err_msg=name)


def test_the_cli_trains_on_the_cpu_and_refuses_a_mesh(capsys):
    ptrain.main(["--arch", "mamba2-780m", "--device", "cpu", "--steps", "2",
                 "--batch", "2", "--seq", "16", "--power-every", "0"])
    assert "steps=2" in capsys.readouterr().out
    # a mesh of two devices needs two ranks (the mesh trains over four
    # processes in tests/test_torch_mesh.py)
    for kw in (dict(data=2), dict(model=2)):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            ptrain.run(ptrain.TrainJob(arch=ARCH, device="cpu", **kw))


def test_prefill_and_decode_steps_wrap_the_lm():
    _, pcfg, _, plm, _, pparams = setup(ARCH)
    toks = torch.from_numpy(_batch(pcfg)["tokens"]).long()
    with torch.no_grad():
        logits, caches = psteps.make_prefill_step(plm)(pparams,
                                                       {"tokens": toks})
        want, _ = plm.prefill(pparams, toks)
        assert torch.equal(logits, want)
        _, caches = plm.prefill(pparams, toks, max_len=toks.shape[1] + 1)
        step_logits, caches = psteps.make_decode_step(plm)(
            pparams, caches, toks[:, :1])
    assert step_logits.shape == (toks.shape[0], pcfg.vocab_padded)
    assert caches["pos"] == toks.shape[1] + 1
