"""Each kernel's plain PyTorch version against the reference's Pallas
kernel run as the reference's own tests run it on the CPU (interpret
mode): the feature, popcount, toggle, byte-LUT and BDI kernels bit for
bit, the VAMPIRE and baseline charge kernels (mean, surface,
distribution) at rtol 1e-5.  Also: the wrappers take the plain version
only for CPU tensors, count no launch there, and refuse to launch on
anything that is not a CUDA tensor."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dram as rdram
from repro.core import estimate_batch as rbatch
from repro.core import idd_loops, model_api as rma
from repro.core import traces as rtraces
from repro.core import encodings as renc
from repro.kernels.baseline_energy import ops as r_bops
from repro.kernels.bdi import ops as r_bdi_ops
from repro.kernels.bdi.bdi import bdi_sizes_pallas
from repro.kernels.byte_lut import ref as r_lref
from repro.kernels.byte_lut.byte_lut import byte_lut_pallas
from repro.kernels.popcount.popcount import line_ones_pallas
from repro.kernels.toggle import ops as r_tops
from repro.kernels.toggle.toggle import line_toggles_pallas
from repro.kernels.vampire_energy import ops as r_vops
from repro.kernels.vampire_energy import vampire_energy as r_ve
from repro_torch.core import dram as pdram
from repro_torch.core import estimate_batch as pbatch
from repro_torch.core import model_api as pma
from repro_torch.kernels import build, common
from repro_torch.core import encodings as penc
from repro_torch.kernels.baseline_energy import baseline_energy as p_be
from repro_torch.kernels.bdi import bdi as p_bdi
from repro_torch.kernels.bdi import ops as p_bdi_ops
from repro_torch.kernels.byte_lut import byte_lut as p_lut
from repro_torch.kernels.byte_lut import ops as p_lut_ops
from repro_torch.kernels.popcount import ops as p_pc_ops
from repro_torch.kernels.popcount import popcount as p_pc
from repro_torch.kernels.toggle import ops as p_tg_ops
from repro_torch.kernels.toggle import toggle as p_tg
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


def test_feature_plain_version_matches_pallas_bit_for_bit(batches):
    """The feature wrapper on ``(data, cmd, prev_rw)`` against the
    reference's kernel on the previous line and toggle mask that the
    reference's own ``structural_state`` makes for the same batch."""
    import jax
    from repro.core.energy_model import structural_state as r_state
    from repro_torch.core.energy_model import structural_state as p_state
    rtb, ptb = batches
    t, n = ptb.trace.cmd.shape
    st = jax.vmap(r_state)(rtb.trace)
    r_ones, r_togg = r_ve.batched_features_pallas(
        rtb.trace.data.reshape(t * n, -1), st.prev_data.reshape(t * n, -1),
        (st.has_prev & st.is_rw).astype(jnp.float32).reshape(t * n),
        interpret=True)
    before = p_ve.batched_features.launches
    ones, togg = p_ve.batched_features(ptb.trace.data, ptb.trace.cmd,
                                       p_state(ptb.trace).prev_rw)
    assert p_ve.batched_features.launches == before   # CPU: no launch
    assert ones.dtype == togg.dtype == torch.float32
    assert ones.shape == togg.shape == (t, n)
    np.testing.assert_array_equal(ones.numpy().reshape(-1), np.asarray(r_ones))
    np.testing.assert_array_equal(togg.numpy().reshape(-1), np.asarray(r_togg))


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
                                     "baseline_energy", "line_bits",
                                     "byte_lut", "bdi", "flash_attention",
                                     "flash_attention_bwd"}
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_plain_reduction_layouts():
    """The plain versions' (V, T, N) -> (T, V) / (T, V, 64) reduction and
    the kernels' launch layout (one cluster of tiles per trace, every
    vendor in one group, the output written whole) agree on a hand-made
    case."""
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
    geo = common.charge_geometry(3, 2048 + 1, 2, 132)
    assert (geo.cluster, geo.group, geo.n_groups) == (3, 2, 1)
    assert geo.cluster * geo.tile >= 2048 + 1
    assert geo.vendor_groups(2) == [range(0, 2)]


# (T, N, V): the estimation batch, the study's, the serving report's,
# short and ragged rows, one trace, and vendor counts past one group
GEOMETRY_CASES = [(64, 16384, 3), (92, 15237, 3), (8, 2053, 3), (1, 5, 3),
                  (2, 1000, 1), (1, 1 << 20, 3), (6, 2053, 40), (3, 7, 97),
                  (4096, 128, 3), (1, 0, 2)]


@pytest.mark.parametrize("n_sms", [132, 114, 16, 1])
@pytest.mark.parametrize("t,n,v", GEOMETRY_CASES)
def test_charge_launch_geometry(t, n, v, n_sms):
    """The charge kernels' launch geometry on a card of ``n_sms`` SMs
    (an H100 SXM, an H100 PCIe, small parts): every vendor in exactly
    one group of at most 32, the clusters' tiles cover every command
    with no rank left idle, and a grid past one trace a wave stops at
    one block a trace.  (``charge.cuh`` sizes the shared memory and
    asserts at compile time that a full group of 32 fits a block.)"""
    geo = common.charge_geometry(t, n, v, n_sms)
    groups = geo.vendor_groups(v)
    assert len(groups) == geo.n_groups
    assert sorted(i for g in groups for i in g) == list(range(v))
    assert all(0 < len(g) <= common.MAX_GROUP for g in groups)
    assert geo.group == common.cdiv(v, geo.n_groups)   # as even as a stride
    assert 1 <= geo.cluster <= common.MAX_CLUSTER
    assert geo.tile % (4 * common.THREADS) == 0
    assert geo.cluster * geo.tile >= n
    steps = common.cdiv(n, 4 * common.THREADS)
    assert geo.cluster <= max(1, steps)               # every rank has work
    assert geo.tile == 4 * common.THREADS * common.cdiv(max(steps, 1),
                                                        geo.cluster)
    if t * geo.n_groups >= common.BLOCKS_PER_SM * n_sms:
        assert geo.cluster == 1
    widest = common.charge_geometry(t, n, 32, n_sms)
    assert widest.group == 32 and widest.n_groups == 1


def test_charge_geometry_fills_the_card_at_the_estimation_shape():
    """At (T=64, N=16384, V=3) the grid is one wave of 4-block clusters
    of 4096-command tiles: 256 blocks for 2 x 132 slots."""
    geo = common.charge_geometry(64, 16384, 3, 132)
    assert (geo.cluster, geo.tile, geo.n_groups) == (4, 4096, 1)
    assert 64 * geo.cluster <= common.BLOCKS_PER_SM * 132


def test_charge_planes_share_one_alignment():
    x = torch.zeros(4, 9, dtype=torch.int32)
    assert common.plane_phase(a=x, b=torch.zeros(4, 9)) == 0
    assert common.plane_phase(a=x.view(-1)[1:], b=x.view(-1)[5:]) == 1
    with pytest.raises(ValueError, match="16-byte alignment"):
        common.plane_phase(a=x.view(-1)[1:], b=x.view(-1)[2:])


# ---------------------------------------------------------------------------
# The line kernels: popcount, toggle, byte LUT, BDI
# ---------------------------------------------------------------------------
def _t(lines_u32):
    return torch.from_numpy(np.ascontiguousarray(lines_u32).view(np.int32))


def _line_sets():
    rng = np.random.default_rng(41)
    rand = rng.integers(0, 1 << 32, size=(1500, 16),
                        dtype=np.uint64).astype(np.uint32)
    return {"random": rand, "zeros": np.zeros((37, 16), np.uint32),
            "ones": np.full((37, 16), 0xFFFFFFFF, np.uint32),
            "mixed": np.concatenate([rand[:20], np.zeros((5, 16), np.uint32),
                                     np.full((5, 16), 0xFFFFFFFF, np.uint32),
                                     rand[20:41]])}


@pytest.mark.parametrize("which", ["random", "zeros", "ones", "mixed"])
def test_popcount_and_toggle_plain_versions_match_pallas(which):
    lines = _line_sets()[which]
    prev = np.roll(lines, 3, axis=0) ^ np.uint32(0x0F0F0F0F)
    before = (p_pc.line_ones.launches, p_tg.line_toggles.launches)
    ones = p_pc_ops.line_ones(_t(lines))
    togg = p_tg_ops.line_toggles(_t(lines), _t(prev))
    seq = p_tg_ops.line_toggles_seq(_t(lines))
    assert (p_pc.line_ones.launches, p_tg.line_toggles.launches) == before
    assert ones.dtype == togg.dtype == seq.dtype == torch.int32
    np.testing.assert_array_equal(
        ones.numpy(), np.asarray(line_ones_pallas(lines, interpret=True)))
    np.testing.assert_array_equal(
        togg.numpy(),
        np.asarray(line_toggles_pallas(lines, prev, interpret=True)))
    np.testing.assert_array_equal(
        seq.numpy(), np.asarray(r_tops.line_toggles_seq(lines)))
    assert int(seq[0]) == 0


def test_line_ops_keep_leading_axes():
    lines = _line_sets()["random"][:60]
    x = _t(lines).reshape(3, 20, 16)
    np.testing.assert_array_equal(
        p_pc_ops.line_ones(x).numpy().reshape(-1),
        np.asarray(line_ones_pallas(lines, interpret=True)))
    assert p_tg_ops.line_toggles(x, x.flip(0)).shape == (3, 20)
    assert p_tg_ops.line_toggles_seq(_t(lines[:1])).tolist() == [0]
    assert p_tg_ops.line_toggles_seq(_t(lines[:0])).shape == (0,)


@pytest.mark.parametrize("table", ["permutation", "optimized"])
def test_byte_lut_plain_version_matches_pallas(table):
    rng = np.random.default_rng(43)
    lines = rng.integers(0, 1 << 32, size=(300, 16),
                         dtype=np.uint64).astype(np.uint32)
    lines[:100] &= np.uint32(0x0303FF00)          # a skewed histogram
    if table == "permutation":
        lut = rng.permutation(256).astype(np.int32)
    else:
        lut = renc.optimized_lut(renc.byte_histogram(lines)).astype(np.int32)
        np.testing.assert_array_equal(
            lut, penc.optimized_lut(penc.byte_histogram(_t(lines))))
    b = r_lref.words_to_bytes(lines).reshape(-1)
    want = np.asarray(r_lref.bytes_to_words(
        byte_lut_pallas(b, lut, interpret=True).reshape(-1, 64)))
    before = p_lut.apply_lut_lines.launches
    got = p_lut_ops.apply_lut_lines(_t(lines), lut)
    assert p_lut.apply_lut_lines.launches == before
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  renc.apply_lut(lines, lut))


def _from_u64(vals):
    return np.asarray(vals, np.uint64).reshape(-1, 8).view(
        np.uint32).reshape(-1, 16)


def _from_u16(vals):
    return np.asarray(vals, np.uint16).reshape(-1, 32).view(
        np.uint32).reshape(-1, 16)


def _line8(base, deltas):
    return _from_u64([(base + d) % (1 << 64) for d in deltas])


def _line4(vals):
    return np.asarray([v % (1 << 32) for v in vals], np.uint32).reshape(1, 16)


def bdi_corpus(rng):
    """Lines for each of the 11 schemes, delta edges at +-2^7, +-2^15 and
    +-2^31, 8-byte values wrapping across 2^63 and 2^64, 4-byte values
    around INT32_MIN / INT32_MAX, and lines where several schemes fit."""
    rows = [rng.integers(0, 1 << 32, size=(16, 16),
                         dtype=np.uint64).astype(np.uint32),
            np.zeros((2, 16), np.uint32)]
    b64 = int(rng.integers(1, 1 << 62)) * 2 + 1
    rows.append(_line8(b64, [0] * 8))                                # rep8
    for lim in (1 << 7, 1 << 15, 1 << 31):                           # b8dX
        for ds in ([0, -lim, lim - 1, 3, -1, 0, 2, 1],
                   [0, lim, 1, 2, 3, 4, 5, 6],
                   [0, -lim - 1, 1, 2, 3, 4, 5, 6]):
            rows.append(_line8(b64, ds))
    rows.append(_line8((1 << 63) - 5, [0, 10, 3, 4, 7, 1, 2, 9]))
    rows.append(_line8((1 << 64) - 4, [0, 4, 5, -6, 100, 1, 2, 3]))
    rows.append(_line8(1 << 63, [0, -1, -128, 127, 5, 0, 1, 2]))
    rows.append(_line8((1 << 63) - 1, [0, 1, 2, 3, 1 << 31, 0, 0, 0]))
    i32max, i32min = (1 << 31) - 1, -(1 << 31)
    rows.append(_line4([i32max] + [i32min] * 15))     # wraps to +1 in int32
    rows.append(_line4([i32min] + [i32max] * 15))
    rows.append(_line4([i32min + k for k in range(16)]))
    rows.append(_line4([i32max - k for k in range(16)]))
    rows.append(_line4([i32max - 100 + 300 * k for k in range(16)]))
    b32 = 0x12345678
    rows.append(_line4([b32] * 16))                                  # rep4
    for lim in (1 << 7, 1 << 15):                                    # b4dX
        for ds in ([0, -lim, lim - 1] + [1] * 13, [0, lim] + [2] * 14,
                   [0, -lim - 1] + [3] * 14):
            rows.append(_line4([b32 + d for d in ds]))
    rows.append(_from_u16([0xBEEF] * 32))                            # rep2
    rows.append(_from_u16([0x7FFF] + [0x8000] * 31))
    for ds in ([0, -128, 127] + [5] * 29, [0, 128] + [1] * 30):      # b2d1
        rows.append(_from_u16([(0x1234 + d) % (1 << 16) for d in ds]))
    # ties: several schemes fit, the smallest wins
    rows.append(_from_u16([0xFFFF, 0x0000] * 16))           # rep4 over b8d1
    rows.append(_line4([0x01010101] * 16))                  # rep2 over rep4
    rows.append(_line8(0, range(8)))                        # b8d1 over b4d1
    rows.append(np.full((1, 16), 0xFFFFFFFF, np.uint32))
    rows.append(rng.integers(0, 5, size=(4, 16)).astype(np.uint32)
                + np.uint32(0x7FFFFFF0))
    return np.concatenate(rows).astype(np.uint32)


def test_bdi_plain_version_matches_pallas_sizes_and_schemes():
    lines = bdi_corpus(np.random.default_rng(47))
    r_sizes, r_schemes = bdi_sizes_pallas(renc.words_to_bytes(
        lines).astype(np.int32), interpret=True)
    before = p_bdi.bdi_sizes.launches
    sizes, schemes = p_bdi_ops.bdi_sizes(_t(lines))
    assert p_bdi.bdi_sizes.launches == before
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(r_sizes))
    np.testing.assert_array_equal(schemes.numpy(), np.asarray(r_schemes))
    assert set(schemes.tolist()) == set(p_bdi.SCHEME_SIZES)   # all 11
    assert all(p_bdi.SCHEME_SIZES[k] == v for k, v in
               zip(schemes.tolist(), sizes.tolist()))
    # the port's own offline encoder, and the reference's
    p_lines, p_sizes = penc.bdi_encode_lines(_t(lines))
    r_lines, r_sizes_off = renc.bdi_encode_lines(lines)
    np.testing.assert_array_equal(sizes.numpy(), p_sizes)
    np.testing.assert_array_equal(p_sizes, r_sizes_off)
    np.testing.assert_array_equal(p_lines, r_lines)


def test_bdi_compression_ratio_matches_reference():
    rng = np.random.default_rng(53)
    lines = np.concatenate([bdi_corpus(rng), rng.integers(
        0, 300, size=(200, 16)).astype(np.uint32)])
    want = float(r_bdi_ops.compression_ratio(jnp.asarray(lines)))
    got = p_bdi_ops.compression_ratio(_t(lines))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_kernel_data_ops_match_the_plain_feature_pass(batches):
    from repro_torch.core.energy_model import (extract_structural_features,
                                               kernel_data_ops)
    _, ptb = batches
    a = extract_structural_features(ptb.trace)
    b = extract_structural_features(ptb.trace, data_ops=kernel_data_ops())
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name
    tr = _bridge(rtraces.app_trace(rtraces.SPEC_APPS[2], n_requests=60))
    c = extract_structural_features(tr, data_ops=kernel_data_ops())
    assert torch.equal(c.ones, extract_structural_features(tr).ones)


def test_line_kernel_wrappers_refuse_non_cuda_tensors():
    meta = torch.zeros(4, 16, dtype=torch.int32, device="meta")
    lut = torch.zeros(256, dtype=torch.int32, device="meta")
    plane = torch.zeros(2, 2, dtype=torch.int32, device="meta")
    for call in (lambda: p_ve.batched_features(meta.view(2, 2, 16), plane,
                                               plane),
                 lambda: p_pc.line_ones(meta),
                 lambda: p_tg.line_toggles(meta, meta),
                 lambda: p_lut.apply_lut_lines(meta, lut),
                 lambda: p_bdi.bdi_sizes(meta)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
