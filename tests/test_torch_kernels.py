"""Each kernel's plain PyTorch version against the reference's Pallas
kernel run as the reference's own tests run it on the CPU (interpret
mode): the feature kernel bit for bit, the VAMPIRE and baseline charge
kernels (mean, surface, distribution) at rtol 1e-5.  Also: the wrappers
take the plain version only for CPU tensors, count no launch there, and
refuse to launch on anything that is not a CUDA tensor."""
import pathlib

import numpy as np
import pytest
import torch

from repro.core import dram as rdram
from repro.core import estimate_batch as rbatch
from repro.core import idd_loops, model_api as rma
from repro.core import traces as rtraces
from repro.kernels.baseline_energy import ops as r_bops
from repro.kernels.vampire_energy import ops as r_vops
from repro.kernels.vampire_energy import vampire_energy as r_ve
from repro_torch.core import dram as pdram
from repro_torch.core import estimate_batch as pbatch
from repro_torch.core import model_api as pma
from repro_torch.kernels import build, common
from repro_torch.kernels.baseline_energy import baseline_energy as p_be
from repro_torch.kernels.baseline_energy import ops as p_bops
from repro_torch.kernels.vampire_energy import ops as p_vops
from repro_torch.kernels.vampire_energy import ref as p_vref
from repro_torch.kernels.vampire_energy import vampire_energy as p_ve

RTOL = 1e-5
MODEL = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "data" / "vampire_quickfit_v2.npz")


def _bridge(tr):
    return pdram.make_trace(*[np.asarray(f) for f in tr])


@pytest.fixture(scope="module")
def models():
    return (rma.load_estimator(str(MODEL)),
            pma.load_estimator(str(MODEL), device="cpu"))


@pytest.fixture(scope="module")
def batches():
    P = rdram
    lowpower = rdram.make_trace(
        [P.ACT, P.RD, P.PREA, P.PDE_SLOW, P.NOP, P.PDX, P.ACT, P.PDE, P.NOP,
         P.PDX, P.PREA, P.SRE, P.NOP, P.SRX, P.ACT, P.WR, P.PRE],
        [0, 0, 0, 0, 0, 0, 3, 3, 3, 3, 3, 0, 0, 0, 1, 1, 1],
        [5, 5, 0, 0, 0, 0, 9, 9, 9, 9, 0, 0, 0, 0, 2, 2, 0],
        [0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 0], None,
        [6, 4, 6, 3, 250, 24, 6, 3, 180, 5, 6, 3, 800, 74, 6, 4, 6])
    trs = [rtraces.app_trace(rtraces.SPEC_APPS[5], n_requests=120),
           idd_loops.validation_sweep(20), lowpower,
           rtraces.app_trace(rtraces.SPEC_APPS[12], n_requests=70)]
    # a bucket with a zero-weight pad row
    rtb = rbatch.bucketed_trace_batch(trs, 5, 640)
    ptb = pbatch.bucketed_trace_batch([_bridge(t) for t in trs], 5, 640)
    return rtb, ptb


def test_feature_plain_version_matches_pallas_bit_for_bit():
    rng = np.random.default_rng(23)
    data = rng.integers(0, 1 << 32, size=(777, 16),
                        dtype=np.uint64).astype(np.uint32)
    prev = rng.integers(0, 1 << 32, size=(777, 16),
                        dtype=np.uint64).astype(np.uint32)
    tmask = (rng.random(777) < 0.6).astype(np.float32)
    r_ones, r_togg = r_ve.batched_features_pallas(data, prev, tmask,
                                                  interpret=True)
    before = p_ve.batched_features.launches
    ones, togg = p_ve.batched_features(torch.from_numpy(data.view(np.int32)),
                                       torch.from_numpy(prev.view(np.int32)),
                                       torch.from_numpy(tmask))
    assert p_ve.batched_features.launches == before   # CPU: no launch
    assert ones.dtype == togg.dtype == torch.float32
    np.testing.assert_array_equal(ones.numpy(), np.asarray(r_ones))
    np.testing.assert_array_equal(togg.numpy(), np.asarray(r_togg))


@pytest.mark.parametrize("variant", ["mean", "surface", "distribution"])
def test_vampire_charge_plain_version_matches_pallas(models, batches,
                                                     variant):
    rm, pm = models
    rtb, ptb = batches
    kw = (dict(ones_frac=np.float32(0.35), toggle_frac=np.float32(0.15))
          if variant == "distribution" else {})
    surface = variant == "surface"
    r_charge, r_cycles = r_vops.batched_charge_matrix(
        rtb.trace, rtb.weight, rm.fleet.params, surface=surface,
        interpret=True, **kw)
    counts = (p_ve.vampire_charge.launches,
              p_ve.vampire_charge_surface.launches)
    p_charge, p_cycles = p_vops.batched_charge_matrix(
        ptb.trace, ptb.weight, pm.fleet.params, surface=surface, **kw)
    assert counts == (p_ve.vampire_charge.launches,
                      p_ve.vampire_charge_surface.launches)
    np.testing.assert_allclose(p_charge.numpy(), np.asarray(r_charge),
                               rtol=RTOL)
    np.testing.assert_array_equal(p_cycles.numpy(), np.asarray(r_cycles))
    assert float(p_charge[4].abs().sum()) == 0.0          # the pad row


@pytest.mark.parametrize("kind", ["micron", "drampower"])
@pytest.mark.parametrize("surface", [False, True])
def test_baseline_charge_plain_version_matches_pallas(models, batches, kind,
                                                      surface):
    from repro.core.baselines_power import BASELINE_MODELS
    rm, pm = models
    rtb, ptb = batches
    r_table = BASELINE_MODELS[kind].from_vampire(rm).idd_table
    p_table = pma.make_estimator(kind, pm).idd_table
    np.testing.assert_array_equal(p_table.numpy(), np.asarray(r_table))
    r_charge, r_cycles = r_bops.baseline_charge_matrix(
        rtb.trace, rtb.weight, r_table, kind, surface=surface,
        interpret=True)
    before = p_be.WRAPPERS[kind, surface].launches
    p_charge, p_cycles = p_bops.baseline_charge_matrix(
        ptb.trace, ptb.weight, p_table, kind, surface=surface)
    assert p_be.WRAPPERS[kind, surface].launches == before
    np.testing.assert_allclose(p_charge.numpy(), np.asarray(r_charge),
                               rtol=RTOL)
    np.testing.assert_array_equal(p_cycles.numpy(), np.asarray(r_cycles))


def test_kernel_assembler_matches_its_plain_twin(models, batches):
    """``ref.batched_charge_ref`` (the unfused vectorized integrator) pins
    the (charge, cycles) contract of ``ops.batched_charge_matrix``."""
    _, pm = models
    _, ptb = batches
    a_charge, a_cycles = p_vops.batched_charge_matrix(
        ptb.trace, ptb.weight, pm.fleet.params)
    b_charge, b_cycles = p_vref.batched_charge_ref(ptb.trace, ptb.weight,
                                                   pm.fleet.params)
    np.testing.assert_allclose(a_charge.numpy(), b_charge.numpy(), rtol=RTOL)
    assert torch.equal(a_cycles, b_cycles)


def test_packed_parameter_rows_match_reference_blocks(models):
    rm, pm = models
    coeffs, scal, bvec = r_ve.pack_param_blocks(rm.fleet.params)
    rows = p_vops.pack_param_blocks(pm.fleet.params).numpy()
    assert rows.shape == (3, p_ve.P_SIZE)
    np.testing.assert_array_equal(rows[:, :24],
                                  np.asarray(coeffs).reshape(3, 24))
    np.testing.assert_array_equal(rows[:, 24:35], np.asarray(scal))
    np.testing.assert_array_equal(rows[:, 35:59],
                                  np.asarray(bvec).reshape(3, 24))
    np.testing.assert_array_equal(
        rows[:, 59:], np.asarray(rm.fleet.params.act_surface).reshape(3, 64))


def test_packed_state_word_round_trips(batches):
    from repro_torch.core.energy_model import structural_state
    _, ptb = batches
    st = structural_state(ptb.trace)
    word = p_vops.pack_state(st)
    assert torch.equal(word & 3, st.il_mode)
    assert torch.equal((word >> 2) & 7, st.bg_state)
    bits = ((word >> 8)[..., None] >> torch.arange(8)) & 1
    assert torch.equal(bits.bool(), st.open_before)


def test_wrappers_refuse_non_cuda_tensors(batches, models):
    """On a tensor that is not a CUDA tensor the launch path raises; it
    never falls back to the plain version."""
    x = torch.zeros(4, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        common.require_cuda({"data": x}, {"data": torch.int32},
                            {"data": (4, 16)})
    _, ptb = batches
    _, pm = models
    t, n = ptb.trace.cmd.shape
    args = (torch.zeros(t, n), torch.zeros(t, n), ptb.trace.cmd,
            ptb.trace.bank, ptb.trace.row, ptb.trace.dt,
            torch.zeros(t, n, dtype=torch.int32), ptb.weight,
            p_vops.pack_param_blocks(pm.fleet.params))
    with pytest.raises(ValueError, match="CUDA tensor"):
        p_ve._launch_vampire(False, *args)


def test_build_names_libraries_by_content_and_needs_nvcc(monkeypatch):
    a = build._target("features")
    assert a.parent == build.BUILD_DIR and a.suffix == ".so"
    assert a == build._target("features")
    assert a != build._target("vampire_energy")
    assert set(build.SIGNATURES) == {"features", "vampire_energy",
                                     "baseline_energy"}
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_plain_reduction_layouts():
    """The plain versions' (V, T, N) -> (T, V) / (T, V, 64) reduction and
    the kernels' partial-sum layout agree on a hand-made case."""
    cw = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
    bank = torch.tensor([[0, 1, 0, 7, 7]] * 3, dtype=torch.int32)
    row = torch.tensor([[0, 4096, 8191, 0, 32767]] * 3, dtype=torch.int32)
    mean = common.reduce_charge(cw, bank, row, False)
    assert torch.equal(mean, cw.sum(-1).T)
    surf = common.reduce_charge(cw, bank, row, True)
    assert surf.shape == (3, 2, 64)
    assert torch.equal(surf.sum(-1), mean)
    assert float(surf[0, 0, 1]) == float(cw[0, 0, 2])     # bank 0, band 1
    assert float(surf[0, 0, 63]) == float(cw[0, 0, 4])    # bank 7, band 7
    padded, n = common.pad_to(cw, 4, axis=2, value=-1.0)
    assert n == 5 and padded.shape == (2, 3, 8)
    assert bool((padded[..., 5:] == -1.0).all())
    assert common.pad_to(cw, 5, axis=2)[0] is cw
    assert common.cdiv(2049, 1024) == 3
    part = common.partials(2, 3, 2048 + 1, True, "cpu")
    assert part.shape == (2, 3, 3, 64)
    assert common.sum_partials(torch.ones(2, 3, 3)).shape == (3, 2)
