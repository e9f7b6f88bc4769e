"""The CUDA kernels on the card: each against its plain version, the
launch counts, the wrappers' input checks, and ``impl='cuda'`` against
``impl='vectorized'`` end to end.  Needs an NVIDIA GPU and ``nvcc``; on a
machine without a card every test skips, naming the missing device.

Run on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``
(``PYTHONPATH=src``)."""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import model_api, traces
from repro_torch.core.dram import ACT
from repro_torch.core.estimate_batch import bucketed_trace_batch
from repro_torch.core.energy_model import prev_lines, structural_state
from repro_torch.kernels.baseline_energy import baseline_energy as be
from repro_torch.kernels.vampire_energy import ops as vops
from repro_torch.kernels.vampire_energy import vampire_energy as ve

pytestmark = pytest.mark.cuda

MODEL = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "data" / "vampire_quickfit_v2.npz")
RTOL = 1e-5


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "False on this machine")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup(device):
    trs = [traces.app_trace(traces.SPEC_APPS[i], n_requests=n)
           for i, n in ((0, 300), (7, 500), (13, 200), (18, 400))]
    tb = bucketed_trace_batch(trs, 6, 2048 + 5).to(device)
    vampire = model_api.load_estimator(str(MODEL), device=device)
    models = {k: model_api.make_estimator(k, vampire)
              for k in model_api.ESTIMATOR_KINDS}
    return trs, tb, models


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(), rtol=rtol)


def test_features_kernel_is_bit_exact(device):
    gen = torch.Generator().manual_seed(5)
    data = torch.randint(-2**31, 2**31 - 1, (4099, 16), generator=gen,
                         dtype=torch.int32).to(device)
    prev = torch.randint(-2**31, 2**31 - 1, (4099, 16), generator=gen,
                         dtype=torch.int32).to(device)
    tmask = (torch.rand(4099, generator=gen) < 0.5).float().to(device)
    before = ve.batched_features.launches
    ones, togg = ve.batched_features(data, prev, tmask)
    torch.cuda.synchronize()
    assert ve.batched_features.launches == before + 1
    p_ones, p_togg = ve.batched_features_plain(data, prev, tmask)
    assert torch.equal(ones, p_ones) and torch.equal(togg, p_togg)


@pytest.mark.parametrize("surface", [False, True])
def test_vampire_charge_kernel_matches_plain(setup, surface):
    _, tb, models = setup
    tr = tb.trace
    st = structural_state(tr)
    t, n = tr.cmd.shape
    ones, togg = ve.batched_features(
        tr.data.reshape(t * n, -1), prev_lines(tr.data, st).reshape(t * n, -1),
        (st.has_prev & st.is_rw).float().reshape(-1))
    args = (ones.reshape(t, n), togg.reshape(t, n), tr.cmd, tr.bank, tr.row,
            tr.dt, vops.pack_state(st), tb.weight,
            vops.pack_param_blocks(models["vampire"].fleet.params))
    fn = ve.vampire_charge_surface if surface else ve.vampire_charge
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    _close(got, ve.vampire_charge_plain(*args, surface=surface))


@pytest.mark.parametrize("kind", be.KINDS)
@pytest.mark.parametrize("surface", [False, True])
def test_baseline_charge_kernel_matches_plain(setup, kind, surface):
    _, tb, models = setup
    tr = tb.trace
    args = (tr.cmd, tr.bank, tr.row, tr.dt,
            vops.pack_state(structural_state(tr)), tb.weight,
            (tr.cmd == ACT).any(-1).float(), models[kind].idd_table)
    fn = be.WRAPPERS[kind, surface]
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    _close(got, be.baseline_charge_plain(kind, *args, surface=surface))


def _charge_inputs(device, params3, table3, t, n, v, offset, seed):
    """Seeded per-command planes that use every command, background state,
    interleave mode and open-bank mask, starting ``offset`` elements past
    a 16-byte boundary; ``v`` vendors: the three fitted ones repeated with
    small seeded perturbations."""
    rng = np.random.default_rng(seed)

    def plane(values, dtype):
        buf = torch.zeros(t * n + offset, dtype=dtype, device=device)
        x = buf[offset:].view(t, n)
        x.copy_(torch.as_tensor(values, dtype=dtype))
        return x

    shape = (t, n)
    bg = np.arange(t * n).reshape(shape) % 5            # every bg state
    state = (rng.integers(0, 4, shape) | (bg << 2)
             | (rng.integers(0, 256, shape) << 8))
    ones = rng.integers(0, 513, shape).astype(np.float32)
    planes = dict(
        ones=plane(ones, torch.float32),
        togg=plane(np.minimum(rng.integers(0, 513, shape), ones),
                   torch.float32),
        cmd=plane(rng.integers(0, 6, shape), torch.int32),
        bank=plane(rng.integers(0, 8, shape), torch.int32),
        row=plane(rng.integers(0, 1 << 15, shape), torch.int32),
        dt=plane(rng.integers(0, 40, shape), torch.int32),
        state=plane(state, torch.int32),
        w=plane((rng.random(shape) < 0.9).astype(np.float32), torch.float32))
    reps = -(-v // 3)
    jitter = 1 + 0.01 * rng.standard_normal((reps * 3, 1))
    params = (params3.cpu().repeat(reps, 1).double().numpy() * jitter)[:v]
    table = (table3.cpu().repeat(reps, 1).double().numpy() * jitter)[:v]
    any_act = (rng.random(t) < 0.8).astype(np.float32)
    return (planes,
            torch.as_tensor(params, dtype=torch.float32, device=device),
            torch.as_tensor(table, dtype=torch.float32, device=device),
            torch.as_tensor(any_act, device=device))


def _charge_calls(planes, params, table, any_act):
    """(wrapper, args, plain) for the six charge wrappers."""
    p = planes
    vargs = (p["ones"], p["togg"], p["cmd"], p["bank"], p["row"], p["dt"],
             p["state"], p["w"], params)
    bargs = (p["cmd"], p["bank"], p["row"], p["dt"], p["state"], p["w"],
             any_act, table)
    calls = [(ve.vampire_charge, vargs,
              lambda: ve.vampire_charge_plain(*vargs)),
             (ve.vampire_charge_surface, vargs,
              lambda: ve.vampire_charge_plain(*vargs, surface=True))]
    for (kind, surface), fn in be.WRAPPERS.items():
        calls.append((fn, bargs, lambda k=kind, s=surface:
                      be.baseline_charge_plain(k, *bargs, surface=s)))
    return calls


# (T, N, V, element offset of the planes): N shorter than one tile and not
# a multiple of 4, one trace, vendor counts past one group of 32, and two
# full groups (the largest shared memory a block takes)
CHARGE_EDGES = [(1, 5, 3, 0), (1, 1000, 3, 1), (3, 2053, 3, 3),
                (1, 2053, 40, 2), (5, 9001, 3, 0), (2, 2053, 67, 1),
                (130, 64, 3, 0), (2, 2053, 64, 2)]


@pytest.mark.parametrize("t,n,v,offset", CHARGE_EDGES)
def test_charge_kernels_at_the_edges(device, setup, t, n, v, offset):
    """Each charge wrapper against its plain version (rtol 1e-5) at edge
    shapes and alignments, with every background state, one launch per
    call, and the same bits from a second call."""
    _, _, models = setup
    planes, params, table, any_act = _charge_inputs(
        device, vops.pack_param_blocks(
            models["vampire"].fleet.params), models["micron"].idd_table,
        t, n, v, offset, seed=t * 1000 + n + v)
    assert set(((planes["state"] >> 2) & 7).unique().tolist()) == set(
        range(5))
    for fn, args, plain in _charge_calls(planes, params, table, any_act):
        before = fn.launches
        got = fn(*args)
        assert fn.launches == before + 1, fn.__name__
        assert got.shape == ((t, v, 64) if "surface" in fn.__name__
                             else (t, v))
        _close(got, plain())
        assert torch.equal(got, fn(*args)), fn.__name__


def test_charge_kernels_add_nothing_for_pad_rows_and_commands(device,
                                                               setup):
    """Zero-weight rows and NOP / dt = 0 pad commands add exactly zero;
    a batch padded with them matches the unpadded one."""
    _, _, models = setup
    t, n, pad = 4, 2053, 3000
    planes, params, table, any_act = _charge_inputs(
        device, vops.pack_param_blocks(
            models["vampire"].fleet.params), models["micron"].idd_table,
        t, n + pad, 3, 0, seed=11)
    planes["w"][1] = 0.0                               # a zero-weight row
    for name in ("cmd", "dt", "w"):                    # NOP / dt=0 padding
        planes[name][:, n:] = 0
    short = {k: x[:, :n].contiguous() for k, x in planes.items()}
    full = _charge_calls(planes, params, table, any_act)
    cut = _charge_calls(short, params, table, any_act)
    for (fn, args, _), (_, sargs, plain) in zip(full, cut):
        got = fn(*args)
        assert bool((got[1] == 0).all()), fn.__name__
        _close(got, fn(*sargs))
        _close(got, plain())


def test_wrappers_check_their_inputs(setup):
    _, tb, models = setup
    tr = tb.trace
    t, n = tr.cmd.shape
    good = (torch.zeros(t, n, device=tr.device),) * 2 + (
        tr.cmd, tr.bank, tr.row, tr.dt, torch.zeros_like(tr.cmd), tb.weight,
        vops.pack_param_blocks(models["vampire"].fleet.params))
    with pytest.raises(TypeError, match="dtype"):
        ve.vampire_charge(*good[:2], tr.cmd.long(), *good[3:])
    with pytest.raises(ValueError, match="CUDA tensor"):
        ve.vampire_charge(good[0].cpu(), *good[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ve.vampire_charge(*good[:2], tr.cmd.t().contiguous().t(), *good[3:])
    shifted = torch.zeros(t * n + 1, device=tr.device)[1:].view(t, n)
    with pytest.raises(ValueError, match="16-byte alignment"):
        ve.vampire_charge(shifted, *good[1:])


@pytest.mark.parametrize("kind", model_api.ESTIMATOR_KINDS)
def test_cuda_impl_matches_vectorized_on_the_card(setup, kind):
    _, tb, models = setup
    est = models[kind]
    for mode, kw in (("mean", {}), ("surface", {}),
                     ("distribution", dict(ones_frac=0.35,
                                           toggle_frac=0.15))):
        a = est.estimate(tb, mode=mode, impl="cuda", **kw)
        b = est.estimate(tb, mode=mode, impl="vectorized", **kw)
        for la, lb in zip(a, b):
            _close(la, lb)


def _lines(device, n=4099, seed=7):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-2**31, 2**31 - 1, (n, 16), generator=gen,
                      dtype=torch.int32)
    x[:64] &= 0x00FF00FF          # compressible and skewed lines
    x[64:80] = 0
    x[80:96] = -1
    return x.to(device)


def test_line_kernels_are_bit_exact(device):
    from repro_torch.kernels.bdi import bdi, ref as bdi_ref
    from repro_torch.kernels.byte_lut import byte_lut, ref as lut_ref
    from repro_torch.kernels.popcount import popcount, ref as pc_ref
    from repro_torch.kernels.toggle import ops as tops, ref as tg_ref, toggle
    x = _lines(device)
    prev = x.roll(5, 0).contiguous()
    lut = torch.randperm(256, generator=torch.Generator().manual_seed(3)
                         ).to(torch.int32).to(device)
    cases = [
        (popcount.line_ones, (x,), pc_ref.line_ones(x)),
        (toggle.line_toggles, (x, prev), tg_ref.line_toggles(x, prev)),
        (byte_lut.apply_lut_lines, (x, lut), lut_ref.apply_lut_lines(x, lut)),
        (bdi.bdi_sizes, (x,), bdi_ref.bdi_sizes(x)),
    ]
    for fn, args, want in cases:
        before = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, fn.__name__
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), fn.__name__
    seq = tops.line_toggles_seq(x)
    assert int(seq[0]) == 0
    assert torch.equal(seq, tg_ref.line_toggles_seq(x))


SEQ_LENGTHS = [0, 1, 2, 7, 8, 9, 255, 256, 257, 524_288 + 13]


@pytest.mark.parametrize("n", SEQ_LENGTHS)
def test_sequential_toggles_at_any_length_and_alignment(device, n):
    """One kernel a call (none for n = 0), the plain version's bits, the
    same bits twice; on a buffer's start, a view one line in and a view
    16 bytes in."""
    from repro_torch.kernels.toggle import ops as tops, ref as tg_ref, toggle
    buf = _lines(device, n + 1, seed=n)
    words = buf.reshape(-1)
    views = {"start": buf[:n], "one line in": buf[1:],
             "16 bytes in": words[4:4 + 16 * n].view(n, 16)}
    for name, x in views.items():
        before = toggle.line_toggles.launches
        got = tops.line_toggles_seq(x)
        again = tops.line_toggles_seq(x)
        torch.cuda.synchronize()
        assert toggle.line_toggles.launches == before + (2 if n else 0), name
        assert got.shape == (n,) and got.dtype == torch.int32, name
        assert torch.equal(got, tg_ref.line_toggles_seq(x)), name
        assert torch.equal(got, again), name


def test_sequential_toggles_run_one_device_operation(device):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.toggle import ops as tops
    x = _lines(device, 524_288)
    tops.line_toggles_seq(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tops.line_toggles_seq(x)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(ops) == 1 and "line_toggles_seq" in ops[0], ops


@pytest.mark.parametrize("kind", model_api.ESTIMATOR_KINDS)
def test_addresses_and_empty_batches_on_the_card(setup, kind):
    """Out-of-range banks and rows are refused on the card as on the CPU,
    naming the trace and the command; a batch of empty traces gives
    zeros in every mode and impl."""
    from repro_torch.core import dram
    _, tb, models = setup
    est = models[kind]
    dev = tb.device
    good = dram.make_trace([ACT, dram.PRE], [0, 0], [5, 0], [0, 0], None,
                           [6, 6]).to(dev)
    for bank, row, what in ((9, 5, "bank 9"), (-1, 5, "bank -1"),
                            (1, 40000, "row 40000"), (1, -5, "row -5")):
        fields = [torch.tensor(x, dtype=torch.int32, device=dev) for x in
                  ([ACT, dram.PRE, ACT, dram.RD, dram.PRE],
                   [0, 0, bank, bank, bank], [0, 0, row, row, 0],
                   [0, 0, 0, 1, 0], [6, 6, 6, 4, 6])]
        bad = dram.CommandTrace(*fields[:4], torch.zeros(
            (5, 16), dtype=torch.int32, device=dev), fields[4])
        for impl in ("vectorized", "reference", "cuda"):
            for mode in ("mean", "surface"):
                with pytest.raises(ValueError,
                                   match=f"trace 1, command 2: {what} "):
                    est.estimate([good, bad], mode=mode, impl=impl)
    empty = dram.make_trace([], [], [], [], None, [])
    for mode in ("mean", "range", "distribution", "surface"):
        kw = (dict(ones_frac=0.35, toggle_frac=0.15)
              if mode == "distribution" else {})
        shape = (2, 3) + ((8, 8) if mode == "surface" else ())
        for impl in ("vectorized", "reference", "cuda"):
            rep = est.estimate([empty, empty], mode=mode, impl=impl, **kw)
            for leaf in (rep if mode == "range" else (rep,)):
                for name, x in zip(leaf._fields, leaf):
                    assert x.device.type == "cuda", (mode, impl, name)
                    assert tuple(x.shape) == shape, (mode, impl, name)
                    assert not bool(x.any()), (mode, impl, name)


def test_tensor_stats_on_the_card_matches_the_cpu(device):
    from repro_torch.core import hbm
    x = torch.randn(512, 1024).to(torch.bfloat16)
    assert hbm.tensor_stats(x.to(device)) == hbm.tensor_stats(x)


# (BH, Sq, BH_kv, Skv, D): the reference's kernel sweep (test_kernels.py),
# ragged lengths, the serving prefill (qwen2.5-3b, B=4, S=2048), and the
# edges of the kernel's 128-row, 128-key tiles: groups of 7 and 4 and 1 at
# D=128 with group * Sq not a multiple of 128, fewer keys than one tile,
# D=64 with one row past a tile, D=8 padded to the 64-column instance, and
# a group of 7 with more work items than the card has SMs
FLASH_SHAPES = [(4, 256, 2, 256, 32), (2, 512, 2, 512, 64),
                (8, 256, 2, 512, 16), (8, 40, 2, 40, 16), (4, 200, 2, 200, 64),
                (16, 2000, 2, 2000, 128), (6, 77, 3, 77, 24),
                (64, 2048, 8, 2048, 128),
                (14, 300, 2, 300, 128), (8, 333, 2, 333, 128),
                (3, 257, 3, 257, 128), (8, 50, 2, 13, 128),
                (4, 129, 2, 129, 64), (4, 100, 2, 100, 8),
                (28, 1000, 4, 1000, 64)]   # more work items than SMs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(device, dtype, shape):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    bh, sq, bh_kv, skv, d = shape
    gen = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(*s, generator=gen).to(device, dtype)
               for s in ((bh, sq, d), (bh_kv, skv, d), (bh_kv, skv, d)))
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    for causal, q_offset in ((True, 0), (False, 0), (True, skv - sq + 3)):
        if causal and sq > skv:
            continue
        before = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 1
        want = fa_ref.attention_ref(q, k, v, causal=causal, q_offset=q_offset)
        assert got.dtype == dtype and got.shape == q.shape
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=atol,
                                   err_msg=f"causal={causal} off={q_offset}")


@pytest.mark.parametrize("sm_scale", [-0.3, 0.0])
@pytest.mark.parametrize("shape", [(16, 100, 2, 100, 128), (14, 90, 2, 90, 64)])
def test_flash_attention_kernel_takes_any_scale(device, sm_scale, shape):
    """A negative scale (carried by negating Q on its way in) and a zero
    scale (uniform weights over the visible keys) match the plain version,
    for a group that divides the kernel's 128 rows and one that does not."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    bh, sq, bh_kv, skv, d = shape
    gen = torch.Generator().manual_seed(bh + d)
    q, k, v = (torch.randn(*s, generator=gen).to(device, torch.bfloat16)
               for s in ((bh, sq, d), (bh_kv, skv, d), (bh_kv, skv, d)))
    for causal in (True, False):
        got = fa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
        want = fa_ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=2e-2,
                                   err_msg=f"causal={causal}")


def test_flash_attention_wrapper_checks_its_inputs(device):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q = torch.randn(4, 64, 32, device=device, dtype=torch.bfloat16)
    k = torch.randn(2, 64, 32, device=device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k,
                           k)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(q[..., :30].contiguous(), k[..., :30].contiguous(),
                           k[..., :30].contiguous())
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(q, k.cpu(), k)


# ---------------------------------------------------------------------------
# The campaign and fleet shapes: the module axis on the kernels' vendor axis
# ---------------------------------------------------------------------------
def _probe_batch(device, n_points=48, masked_prefix=True):
    """The quick campaign plan's first probe points; with
    ``masked_prefix`` the first half of every probe's commands is under
    ``skip`` (measured, but weight 0)."""
    from repro_torch.core import characterize, fleet
    pts = characterize.campaign_plan(probe_reps=64,
                                     n_rows=8).probe_points[:n_points]
    if masked_prefix:
        pts = [fleet.ProbePoint(p.label, p.trace, int(p.trace.n) // 2, p.key)
               for p in pts]
    return pts, fleet.ProbeBatch.from_points(pts).to(device)


def _vampire_args(trace, weight, stacked):
    """The charge kernel's inputs, built as ``batched_charge_matrix``
    builds them."""
    return (*vops.charge_planes(trace, weight),
            vops.pack_param_blocks(stacked))


def test_masked_prefix_probe_batch_on_the_card(device):
    """A probe batch whose first half is under ``skip``: the masked
    commands add no charge and still move the state, so ``'cuda'``
    measures the currents of ``'vectorized'`` and of the CPU."""
    from repro_torch.core import device_sim, fleet, params
    pts, batch = _probe_batch(device)
    assert bool((batch.weight[:, :5] == 0).all())
    mods = device_sim.make_fleet([params.ModuleSpec(v, i, 2015)
                                  for v in range(3) for i in range(2)])
    before = (ve.batched_features.launches, ve.vampire_charge.launches)
    got = fleet.run_probes(mods, pts, impl="cuda", batch=batch,
                           device=device)
    assert (ve.batched_features.launches, ve.vampire_charge.launches) == \
        (before[0] + 1, before[1] + 1)
    vec = fleet.run_probes(mods, pts, batch=batch, device=device)
    cpu = fleet.run_probes(mods, pts, device="cpu")
    np.testing.assert_allclose(got, vec, rtol=RTOL)
    np.testing.assert_allclose(got, cpu, rtol=RTOL)


def test_true_params_with_ones_quad_on_the_card(setup):
    """The simulator's true params (``ones_quad = 0.012``, per-module
    datadep and I/O factors) through the charge kernels on the estimation
    batch, against the plain PyTorch path."""
    from repro_torch.core import device_sim, estimate_batch as eb, fleet
    _, tb, _ = setup
    mods = device_sim.make_fleet([device_sim.P.ModuleSpec(v, 3, 2015)
                                  for v in range(3)])
    stacked = fleet.fleet_stacked(mods, tb.device)
    assert torch.allclose(stacked.ones_quad, torch.tensor(
        0.012, device=tb.device))
    for cuda, vec in ((eb.cuda_batched_reports, eb.batched_reports),
                      (eb.cuda_batched_surface_reports,
                       eb.batched_surface_reports)):
        a = cuda(tb.trace, tb.weight, stacked)
        b = vec(tb.trace, tb.weight, stacked)
        for la, lb in zip(a, b):
            _close(la, lb)


@pytest.mark.parametrize("v", [68, 256, 1000])
def test_fleet_width_vendor_axes(device, v):
    """V past 67 through the mean and surface kernels against their plain
    versions (rtol 1e-5), and the chunked surface equal bit for bit to
    the one-shot one."""
    from repro_torch.core import device_sim, estimate_batch as eb
    _, batch = _probe_batch(device, n_points=24)
    _, stacked = device_sim.synth_fleet_params(v, device=device)
    args = _vampire_args(batch.trace, batch.weight, stacked)
    for fn, surface in ((ve.vampire_charge, False),
                        (ve.vampire_charge_surface, True)):
        got = fn(*args)
        assert got.shape == ((24, v, 64) if surface else (24, v))
        _close(got, ve.vampire_charge_plain(*args, surface=surface))
    one = eb.cuda_batched_surface_reports(batch.trace, batch.weight, stacked)
    chunked = eb.chunked_surface_reports(batch.trace, batch.weight, stacked,
                                         module_chunk=64, impl="cuda")
    for name, a, b in zip(one._fields, one, chunked):
        assert torch.equal(a, b), name


QUICK = dict(probe_modules=2, probe_reps=64, n_rows=8)


@pytest.fixture(scope="module")
def quick_fleet_fit(device):
    from repro_torch.core import device_sim, params
    fleet = device_sim.make_fleet([params.ModuleSpec(v, i, 2015)
                                   for v in range(3) for i in range(3)])
    return fleet, model_api.fit("vampire", fleet, impl="cuda", device=device,
                                **QUICK)


def test_run_validation_on_the_card(quick_fleet_fit):
    from repro_torch.core import validate
    fleet, model = quick_fleet_fit
    before = ve.vampire_charge.launches
    got = validate.run_validation(model, fleet=fleet, impl="cuda")
    assert ve.vampire_charge.launches > before
    want = validate.run_validation(model, fleet=fleet)
    assert list(got.raw) == list(want.raw)
    for key, row in want.raw.items():
        np.testing.assert_allclose(list(got.raw[key].values()),
                                   list(row.values()), rtol=RTOL)
    for kind in model_api.ESTIMATOR_KINDS:
        est = model_api.make_estimator(kind, model)
        np.testing.assert_allclose(
            validate.structural_surface_maps(est, impl="cuda"),
            validate.structural_surface_maps(est), rtol=RTOL)


def test_telemetry_on_the_card(quick_fleet_fit, device):
    from repro_torch.core import device_sim, recalibrate
    fleet, model = quick_fleet_fit
    cfg = recalibrate.RecalConfig(slice_size=120)
    drift = device_sim.DriftProcess(aging_rate=8e-3)
    cuda = recalibrate.TelemetrySource(fleet, cfg, drift=drift, impl="cuda",
                                       device=device)
    vec = recalibrate.TelemetrySource(fleet, cfg, drift=drift, device=device)
    for tick in (1, 60):
        (a, ia), (b, ib) = cuda.measure(tick), vec.measure(tick)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(a, b, rtol=RTOL)
    specs = [m.spec for m in fleet]
    fc = recalibrate.StreamingFitter(model, specs, cfg, impl="cuda")
    fv = recalibrate.StreamingFitter(model, specs, cfg)
    _close(fc._predicted, fv._predicted)
    cur, idx = vec.measure(5)
    rc, rv = fc.observe(cur, idx, 5), fv.observe(cur, idx, 5)
    np.testing.assert_allclose(rc.score, rv.score, rtol=1e-4, atol=1e-4)
    _close(fc.stats.mean, fv.stats.mean)


def test_hot_swap_on_the_card(quick_fleet_fit, device):
    import dataclasses

    from repro_torch.core import device_sim, idd_loops, recalibrate
    from repro_torch.kernels import build
    from repro_torch.serving import EstimationService, ServiceConfig
    fleet, model = quick_fleet_fit
    cfg = recalibrate.RecalConfig(slice_size=10_000)
    step = dataclasses.replace(device_sim.NO_DRIFT, step_tick=1,
                               step_frac=0.2)
    fitter = recalibrate.StreamingFitter(model, [m.spec for m in fleet],
                                         cfg, impl="cuda")
    svc = EstimationService(model, ServiceConfig(lint=False, impl="cuda"),
                            fitter=fitter)
    src = recalibrate.TelemetrySource(fleet, cfg, drift=step, impl="cuda",
                                      device=device)
    trs = [idd_loops.idd0(reps=2), idd_loops.idd4r(reps=2)]
    tickets, _ = svc.submit_many(trs)
    svc.drain()
    programs, libs = svc.engine.cache_size(), dict(build._LIBS)
    before = svc.result(tickets[0]).energy_pj
    assert svc.observe_telemetry(*src.measure(1), tick=1).triggered
    tickets, _ = svc.submit_many(trs)
    svc.drain()
    after = svc.result(tickets[0]).energy_pj
    assert svc.metrics().recalibrations == 1
    assert svc.engine.cache_size() == programs and dict(build._LIBS) == libs
    assert not torch.equal(before, after)
    _close(after, fitter.model.estimate(trs, impl="cuda").energy_pj[0])
    _close(after, fitter.model.estimate(trs).energy_pj[0])


# ---------------------------------------------------------------------------
# The analysis gate and the autotuner on the card
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def estimation_batch(device):
    import dataclasses
    from repro_torch.core.estimate_batch import bucketed_trace_batch
    apps = [dataclasses.replace(traces.SPEC_APPS[i % len(traces.SPEC_APPS)],
                                seed=i + 1) for i in range(64)]
    trs = [traces.app_trace(app, n_requests=6000) for app in apps]
    return bucketed_trace_batch(trs, 64, 16384).to(device)


def test_sync_errors_catch_a_planted_round_trip(device):
    """The recorder under ``set_sync_debug_mode("error")`` on the card: an
    ``.item()`` and a copy to the host are caught, a device-only op is
    not, and the mode is restored afterwards."""
    from repro_torch.analysis import dispatch_audit as da
    x = torch.arange(8, dtype=torch.float32, device=device)
    for planted in (lambda: x.sum().item(), lambda: x.cpu()):
        _, rec, sync = da.record(planted, device, sync_errors=True)
        assert sync is not None and "synchroniz" in sync
    _, rec, sync = da.record(lambda: (x * 2).sum(), device, sync_errors=True)
    assert sync is None and rec.host == []
    assert torch.cuda.get_sync_debug_mode() == 0


def test_dispatch_audit_clean_under_sync_errors(setup, device):
    """Every kind x impl x mode on the audit batch: no float64 op, no
    host round trip under ``set_sync_debug_mode("error")``, pad rows
    masked, no build state added by repeats, re-pads or vendor subsets."""
    from repro_torch.analysis import dispatch_audit as da
    _, _, models = setup
    assert da.audit_all(models["vampire"], device=device) == []


def test_dispatch_audit_clean_at_the_estimation_shape(setup,
                                                      estimation_batch):
    from repro_torch.analysis import dispatch_audit as da
    _, _, models = setup
    assert da.audit_all(models["vampire"], tb=estimation_batch,
                        device=estimation_batch.device,
                        recompile=False) == []


@pytest.mark.parametrize("impl", ["vectorized", "cuda"])
def test_a_serving_window_does_not_synchronise(setup, device, impl):
    """F4: the engine's dispatch of a ring window reads no vendor ids
    back from the card (nor anything else)."""
    from repro_torch.analysis import dispatch_audit as da
    from repro_torch.serving import EstimationService, ServiceConfig
    trs, _, models = setup
    svc = EstimationService(models["vampire"],
                            ServiceConfig(lint=False, impl=impl))
    svc.submit_many(trs)
    rb = svc.ring.take(None)
    svc.engine.dispatch(rb.batch, rb.group)               # warm
    rep, rec, sync = da.record(lambda: svc.engine.dispatch(rb.batch,
                                                           rb.group),
                               device, sync_errors=True)
    assert sync is None and rec.host == [] and rec.wide == []
    assert rep.energy_pj.shape[0] == rb.batch.n_traces


@pytest.mark.parametrize("family", ["vampire_energy", "vampire_energy_surface",
                                    "baseline_energy",
                                    "baseline_energy_surface"])
def test_tuned_configs_match_the_default(device, family):
    """Each committed row's geometry gives the default geometry's result
    at rtol 1e-5 and the same bits twice."""
    from repro_torch.kernels import autotune
    rows = autotune.choices((family,))[family]
    for t, n, v in autotune.FAMILY_SHAPES[family]:
        row = rows.get(autotune.shape_bucket(t, n))
        if row is None:
            continue
        assert row["n_vendors"] == v
        cfg = autotune.best_config(family, t, n)
        tuned = autotune.run_charge(family, t, n, v, cfg)
        again = autotune.run_charge(family, t, n, v, cfg)
        default = autotune.run_charge(family, t, n, v,
                                      dict(autotune.DEFAULT_CONFIG))
        torch.cuda.synchronize()
        assert torch.equal(tuned, again)
        _close(tuned, default)
