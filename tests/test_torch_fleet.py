"""The port's command-trace generators and fleet engine against the
reference's: every IDD loop and probe trace field by field (with its
``skip``) and lint clean, the padded probe batches, ``run_probes`` (the
batched engine through ``'vectorized'`` and, on CPU tensors, ``'cuda'``'s
plain versions, and the serial oracle) at rtol 1e-5, the engine's
refusals, the stack cache, and the fleet surface (the chunked dispatch
equal bit for bit across chunkings, pad rows adding zero).

Tests that draw noise through the reference pin
``jax.threefry_partitionable(True)`` for their duration: the port follows
JAX's partitionable Threefry stream, the default from JAX 0.5 only."""
import jax
import numpy as np
import pytest
import torch

from repro.core import characterize as rchar
from repro.core import device_sim as rsim
from repro.core import dram as rdram
from repro.core import fleet as rfleet
from repro.core import idd_loops as ridd
from repro.core import params as rparams
from repro_torch.analysis import trace_lint
from repro_torch.core import characterize as pchar
from repro_torch.core import device_sim as psim
from repro_torch.core import dram as pdram
from repro_torch.core import estimate_batch as pbatch
from repro_torch.core import fleet as pfleet
from repro_torch.core import idd_loops as pidd
from repro_torch.core import params as pparams
from repro_torch.launch.mesh import make_local_mesh

RTOL = 1e-5
SPECS = [(v, i, 2015) for v in range(3) for i in range(2)]

_PAIR = rchar.pair_lines(192, 64, seed=0)
GENERATORS = (
    [(k, ()) for k in ridd.IDD_LOOPS]
    + [("idd0", dict(bank=3, row=0x55, reps=5)),
       ("idd1", dict(data=rdram.line_from_byte(0x5A), reps=3)),
       ("idd4r", dict(reps=2, data=rdram.line_from_byte(0xFF))),
       ("idd4w", dict(reps=2)), ("idd7", dict(reps=2)),
       ("ones_sweep_point", dict(n_ones=0)),
       ("ones_sweep_point", dict(n_ones=100, op=rdram.WR, reps=8)),
       ("ones_sweep_point", dict(n_ones=512, bank=5, row=9, reps=8)),
       ("bank_idle_probe", dict(bank=5)),
       ("bank_read_probe", dict(bank=2, op=rdram.WR, reps=8)),
       ("row_act_probe", dict(row=0x55, reps=8)),
       ("surface_act_probe", dict(bank=7, row=pchar.surface_probe_row(6),
                                  reps=8)),
       ("column_read_probe", dict(col=3, reps=8)),
       ("validation_sweep", dict(n_reads=0)),
       ("validation_sweep", dict(n_reads=1)),
       ("validation_sweep", dict(n_reads=24)),
       ("validation_sweep", dict(n_reads=7, reps=3, byte=0x33))]
    + [("interleave_sweep_point", dict(data_a=_PAIR[0], data_b=_PAIR[1],
                                       il=il, op=op, reps=4))
       for il in ("none", "col", "bank", "bankcol")
       for op in (rdram.RD, rdram.WR)])


def _call(module, name, kw):
    fn = module.IDD_LOOPS[name] if name in module.IDD_LOOPS else \
        getattr(module, name)
    out = fn(**kw) if isinstance(kw, dict) else fn()
    return out if isinstance(out, tuple) and not hasattr(out, "cmd") \
        else (out, None)


def _assert_trace_equal(ref, port):
    for name, a, b in zip(ref._fields, ref, port):
        a = np.asarray(a)
        b = b.cpu().numpy()
        if name == "data":
            b = b.view(np.uint32)
        assert b.shape == a.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def _to_port(tr):
    return pdram.make_trace(*[np.asarray(f) for f in tr])


def _pspec(s):
    return pparams.ModuleSpec(*s)


@pytest.fixture(autouse=True)
def partitionable():
    # pin JAX's partitionable Threefry stream (the port's) for this test
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize("name,kw", GENERATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(GENERATORS)])
def test_generators_equal_the_reference_and_lint_clean(name, kw):
    rtr, rskip = _call(ridd, name, kw)
    ptr, pskip = _call(pidd, name, kw)
    assert pskip == rskip
    _assert_trace_equal(rtr, ptr)
    assert trace_lint.errors_of(trace_lint.lint_trace(ptr)) == []


def test_line_helpers_equal_the_reference():
    for b in (0x00, 0x33, 0xAA, 0xFF, 0x1F5):
        np.testing.assert_array_equal(pdram.line_from_byte(b),
                                      rdram.line_from_byte(b))
    for n in (0, 1, 31, 32, 300, 512):
        np.testing.assert_array_equal(pdram.line_with_n_ones(n),
                                      rdram.line_with_n_ones(n))
        np.testing.assert_array_equal(
            pdram.line_with_n_ones(n, np.random.default_rng(n)),
            rdram.line_with_n_ones(n, np.random.default_rng(n)))
    with pytest.raises(ValueError):
        pdram.line_with_n_ones(513)
    for n1, tg in ((64, 0), (192, 64), (448, 128), (256, 256)):
        for a, b in zip(pchar.pair_lines(n1, tg, seed=3),
                        rchar.pair_lines(n1, tg, seed=3)):
            np.testing.assert_array_equal(a, b)
    tr = ridd.idd0(reps=1)
    _assert_trace_equal(rdram.concat_traces(tr, rdram.tile_trace(tr, 3)),
                        pdram.concat_traces(_to_port(tr), pdram.tile_trace(
                            _to_port(tr), 3)))


@pytest.fixture(scope="module")
def points():
    """A mixed probe list of unequal lengths and skips, in both
    packages."""
    gens = [ridd.ones_sweep_point(256, reps=8), ridd.bank_idle_probe(3),
            ridd.row_act_probe(0x55, reps=16), (ridd.idd4w(reps=3), 0),
            (ridd.idd6(), 0), ridd.interleave_sweep_point(
                *_PAIR, "bankcol", op=rdram.WR, reps=8)]
    ref = [rfleet.ProbePoint(("p", i), tr, skip, 4096 + 7 * i)
           for i, (tr, skip) in enumerate(gens)]
    port = [pfleet.ProbePoint(p.label, _to_port(p.trace), p.skip, p.key)
            for p in ref]
    return ref, port


@pytest.fixture(scope="module")
def fleets():
    ref = rsim.make_fleet([rparams.ModuleSpec(*s) for s in SPECS])
    port = psim.make_fleet([_pspec(s) for s in SPECS])
    return ref, port


def test_probe_batch_equals_the_reference(points):
    ref, port = points
    rb = rfleet.ProbeBatch.from_points(ref)
    pb = pfleet.ProbeBatch.from_points(port)
    _assert_trace_equal(rb.trace, pb.trace)
    np.testing.assert_array_equal(pb.weight.numpy(), np.asarray(rb.weight))
    np.testing.assert_array_equal(pb.keys, rb.keys)
    idx = [4, 0, 2]
    rs, ps = rb.select(idx), pb.select(idx)
    _assert_trace_equal(rs.trace, ps.trace)
    np.testing.assert_array_equal(ps.weight.numpy(), np.asarray(rs.weight))
    np.testing.assert_array_equal(ps.keys, rs.keys)
    rekeyed = pb.with_keys(pb.keys + 1)
    assert rekeyed.trace is pb.trace and list(rekeyed.keys) == \
        list(pb.keys + 1)
    assert pb.to("cpu") is pb


@pytest.mark.parametrize("noisy", [False, True])
def test_batched_currents_match_the_reference(points, fleets, noisy):
    ref = rfleet.run_probes(fleets[0], points[0], noisy=noisy)
    for impl in ("vectorized", "cuda"):
        got = pfleet.run_probes(fleets[1], points[1], noisy=noisy,
                                impl=impl, device="cpu")
        assert got.shape == (len(SPECS), len(points[1]))
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, ref, rtol=RTOL, err_msg=impl)


def test_serial_oracle_matches_the_batched_engine(points, fleets):
    batched = pfleet.run_probes(fleets[1], points[1], device="cpu")
    serial = pfleet.run_probes(fleets[1], points[1], engine="serial",
                               device="cpu")
    np.testing.assert_allclose(serial, batched, rtol=RTOL)


def test_the_engine_refuses_contradictions(points, fleets):
    mods, pts = fleets[1], points[1]
    with pytest.raises(ValueError, match="engine='serial'"):
        pfleet.run_probes(mods, pts, impl="reference", device="cpu")
    with pytest.raises(ValueError, match="requires engine='batched'"):
        pfleet.run_probes(mods, pts, engine="serial", impl="cuda",
                          device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        pfleet.run_probes(mods, pts, engine="sharded", device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        pfleet.run_probes(mods, pts, impl="pallas", device="cpu")
    # a mesh of one device takes the plain dispatch, bit for bit
    mesh = make_local_mesh(1, 1, device="cpu")
    np.testing.assert_array_equal(
        pfleet.run_probes(mods, pts, mesh=mesh, device="cpu"),
        pfleet.run_probes(mods, pts, device="cpu"))
    tb = pfleet.ProbeBatch.from_points(pts)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pfleet.fleet_surface_energy(mods, tb.trace, tb.weight, mesh=mesh,
                                    module_chunk=2, device="cpu")
    with pytest.raises(ValueError, match="oracle"):
        pfleet.fleet_surface_energy(mods, tb.trace, tb.weight,
                                    impl="reference", device="cpu")
    stacked = pfleet.fleet_stacked(mods, "cpu")
    with pytest.raises(ValueError, match="module identities"):
        pfleet.run_probes(stacked, pts)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pfleet.run_probes(mods, pts)


def test_stack_cache_is_keyed_on_identity_and_bounded(fleets):
    cache = pfleet.FleetStackCache(maxsize=2)
    mods = fleets[1]
    a = cache.stacked(mods, "cpu")
    assert cache.stacked(list(mods), "cpu") is a and cache.hits == 1
    assert a.datadep.shape == (len(mods), 4, 2, 3)
    np.testing.assert_array_equal(a.q_ref[3].numpy(),
                                  mods[3].params.q_ref.numpy())
    b = cache.stacked(mods[:2], "cpu")
    c = cache.stacked(mods[2:], "cpu")
    assert cache.misses == 3 and b is not c
    assert cache.stacked(mods, "cpu") is not a     # evicted
    assert pfleet.fleet_stacked(a) is a


@pytest.fixture(scope="module")
def surface_inputs():
    """``bench_fleetscale``'s two validation-sweep traces (skip 2) and a
    synthetic fleet of 11 modules, in both packages."""
    rtrs = [(ridd.validation_sweep(8, reps=12), 2),
            (ridd.validation_sweep(16, reps=8), 2)]
    rtr, rw = rdram.batch_traces(rtrs)
    ptr, pw = pdram.batch_traces([(_to_port(t), s) for t, s in rtrs])
    _, rstacked = rsim.synth_fleet_params(11)
    _, pstacked = psim.synth_fleet_params(11, device="cpu")
    return (rtr, rw, rstacked), (ptr, pw, pstacked)


def test_fleet_surface_matches_the_reference(surface_inputs):
    (rtr, rw, rs), (ptr, pw, ps) = surface_inputs
    want = rfleet.fleet_surface_energy(rs, rtr, rw)
    for impl in ("vectorized", "cuda"):
        got = pfleet.fleet_surface_energy(ps, ptr, pw, impl=impl)
        assert got.charge_ma_cycles.shape == (2, 11, 8, 8)
        for name, a, b in zip(want._fields, want, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                       err_msg=f"{impl} {name}")
    mods = psim.make_fleet([_pspec(s) for s in SPECS])
    got = pfleet.fleet_surface_energy(mods, ptr, pw, device="cpu")
    want = rfleet.fleet_surface_energy(
        rsim.make_fleet([rparams.ModuleSpec(*s) for s in SPECS]), rtr, rw)
    np.testing.assert_allclose(got.energy_pj.numpy(),
                               np.asarray(want.energy_pj), rtol=RTOL)


@pytest.mark.parametrize("impl", ["vectorized", "cuda"])
def test_chunked_surface_is_the_one_shot_surface(surface_inputs, impl):
    """Every chunking gives the one-shot dispatch's bits; the pad modules
    and zero-weight pad traces of the last chunks are sliced off."""
    _, (ptr, pw, ps) = surface_inputs
    one = pfleet.fleet_surface_energy(ps, ptr, pw, impl=impl)
    for mc, tc in ((1, None), (4, None), (5, 1), (11, 2), (64, None)):
        got = pfleet.fleet_surface_energy(ps, ptr, pw, impl=impl,
                                          module_chunk=mc, trace_chunk=tc)
        for name, a, b in zip(one._fields, one, got):
            assert torch.equal(a, b), (mc, tc, name)
    got = pfleet.fleet_surface_energy(ps, ptr, pw, impl=impl, trace_chunk=1)
    assert torch.equal(got.energy_pj, one.energy_pj)


def test_pad_rows_add_zero_to_the_chunked_surface(surface_inputs):
    _, (ptr, pw, ps) = surface_inputs
    one = pbatch.chunked_surface_reports(ptr, pw, ps, module_chunk=4)
    extra = pdram.CommandTrace(*(torch.cat([x, x[:1]]) for x in ptr))
    w = torch.cat([pw, torch.zeros_like(pw[:1])])
    got = pbatch.chunked_surface_reports(extra, w, ps, module_chunk=4,
                                         trace_chunk=2)
    assert not bool(got.charge_ma_cycles[2].any())
    assert not bool(got.cycles[2].any())
    assert torch.equal(got.charge_ma_cycles[:2], one.charge_ma_cycles)
    np.testing.assert_allclose(
        one.charge_ma_cycles.sum(dim=(-2, -1)).numpy(),
        pbatch.batched_reports(ptr, pw, ps).charge_ma_cycles.numpy(),
        rtol=RTOL)
    with pytest.raises(ValueError, match="chunked surfaces"):
        pbatch.chunked_surface_reports(ptr, pw, ps, module_chunk=4,
                                       impl="reference")
