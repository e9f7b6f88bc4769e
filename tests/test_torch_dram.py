"""The port's trace container and generators against the reference:
popcount on int32 bit patterns, trace construction and padding, the
(bucketed) TraceBatch with its weights, and ``app_trace`` field by field
for every synthetic application.  Inputs come from numpy with a seed;
integers must be equal."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dram as rdram
from repro.core import estimate_batch as rbatch
from repro.core import traces as rtraces
from repro_torch.core import dram as pdram
from repro_torch.core import estimate_batch as pbatch
from repro_torch.core import idd_loops
from repro_torch.core import traces as ptraces

_T = rdram.TIMING


def _bridge(tr):
    """A reference CommandTrace as the port's (CPU tensors)."""
    return pdram.make_trace(*[np.asarray(f) for f in tr])


def _to_ref(tr):
    """A port trace (the port's generators) as the reference's."""
    return rdram.make_trace(*[f.numpy() for f in tr[:4]],
                            tr.data.numpy().view(np.uint32), tr.dt.numpy())


def _assert_trace_equal(ref, port):
    for name, r, p in zip(ref._fields, ref, port):
        r = np.asarray(r)
        p = p.numpy()
        if name == "data":
            p = p.view(np.uint32)
        np.testing.assert_array_equal(p, r, err_msg=name)


def _lowpower_fields():
    """Every background state in one trace: fast, slow and active
    power-down, and self-refresh."""
    P = rdram
    return ([P.ACT, P.RD, P.PREA, P.PDE, P.NOP, P.PDX, P.PDE_SLOW, P.NOP,
             P.PDX, P.ACT, P.PDE, P.NOP, P.PDX, P.PREA, P.SRE, P.NOP, P.SRX,
             P.ACT, P.WR, P.PRE],
            [0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 3, 3, 3, 3, 0, 0, 0, 1, 1, 1],
            [5, 5, 0, 0, 0, 0, 0, 0, 0, 9, 9, 9, 9, 0, 0, 0, 0, 2, 2, 0],
            [0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 0],
            None,
            [_T.tRCD, _T.tBURST, _T.tRP, _T.tCKE, 120, _T.tXP, _T.tCKE, 300,
             _T.tXPDLL, _T.tRCD, _T.tCKE, 180, _T.tXP, _T.tRP, _T.tCKE, 900,
             _T.tXS, _T.tRCD, _T.tBURST, _T.tRP])


def test_popcount_matches_reference_on_random_words():
    rng = np.random.default_rng(11)
    words = rng.integers(0, 1 << 32, size=(257, 16), dtype=np.uint64)
    words = words.astype(np.uint32)
    words[0] = 0
    words[1] = 0xFFFFFFFF
    ref = np.asarray(rdram.popcount_u32(words))
    got = pdram.popcount_u32(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    prev = np.roll(words, 1, axis=0)
    np.testing.assert_array_equal(
        pdram.line_ones(torch.from_numpy(words.view(np.int32))).numpy(),
        np.asarray(rdram.line_ones(words)))
    np.testing.assert_array_equal(
        pdram.line_toggles(torch.from_numpy(words.view(np.int32)),
                           torch.from_numpy(prev.view(np.int32))).numpy(),
        np.asarray(rdram.line_toggles(words, prev)))


def test_make_trace_fields_match_reference():
    fields = _lowpower_fields()
    rng = np.random.default_rng(3)
    data = rng.integers(0, 1 << 32, size=(len(fields[0]), 16),
                        dtype=np.uint64).astype(np.uint32)
    args = fields[:4] + (data,) + fields[5:]
    _assert_trace_equal(rdram.make_trace(*args), pdram.make_trace(*args))
    # a broadcast single line and default fields
    line = rdram.line_from_byte(0xA5)
    _assert_trace_equal(rdram.make_trace([1, 3, 2], data=line),
                        pdram.make_trace([1, 3, 2], data=line))


def test_make_trace_rejects_illegal_low_power_commands():
    bad = [rdram.SRE, rdram.ACT, rdram.SRX]
    with pytest.raises(ValueError, match="self-refresh"):
        rdram.make_trace(bad)
    with pytest.raises(ValueError, match="self-refresh"):
        pdram.make_trace(bad)
    with pytest.raises(ValueError, match="power-down"):
        pdram.make_trace([rdram.PDE, rdram.RD, rdram.PDX])


def test_pad_and_batch_traces_match_reference():
    trs = [_to_ref(idd_loops.validation_sweep(8)),
           rdram.make_trace(*_lowpower_fields())]
    rb, rw = rdram.batch_traces([(trs[0], 3), (trs[1], 0)])
    pb, pw = pdram.batch_traces([(_bridge(trs[0]), 3), (_bridge(trs[1]), 0)])
    _assert_trace_equal(rb, pb)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
    padded = pdram.pad_trace(_bridge(trs[1]), trs[1].n + 7)
    _assert_trace_equal(rdram.pad_trace(trs[1], trs[1].n + 7), padded)
    with pytest.raises(ValueError):
        pdram.pad_trace(padded, 3)


def test_trace_batches_match_reference_with_pad_rows():
    trs = [rtraces.app_trace(rtraces.SPEC_APPS[i], n_requests=n)
           for i, n in ((1, 30), (6, 45))]
    trs.append(rdram.make_trace(*_lowpower_fields()))
    ported = [_bridge(t) for t in trs]
    for rtb, ptb in (
            (rbatch.TraceBatch.from_traces(trs),
             pbatch.TraceBatch.from_traces(ported)),
            (rbatch.bucketed_trace_batch(trs, 5, 256),
             pbatch.bucketed_trace_batch(ported, 5, 256))):
        _assert_trace_equal(rtb.trace, ptb.trace)
        np.testing.assert_array_equal(ptb.weight.numpy(),
                                      np.asarray(rtb.weight))
        assert ptb.weight.dtype == torch.float32
        assert ptb.n_traces == rtb.n_traces
    with pytest.raises(ValueError, match="exceeds the length bucket"):
        pbatch.bucketed_trace_batch(ported, 5, 8)
    with pytest.raises(ValueError, match="exceed"):
        pbatch.bucketed_trace_batch(ported, 2, 256)


def test_original_traces_recovers_rows():
    trs = [idd_loops.validation_sweep(4), _bridge(
        rdram.make_trace(*_lowpower_fields()))]
    tb = pbatch.as_trace_batch(trs)
    assert pbatch.original_traces(trs, tb) == trs
    rows = pbatch.original_traces(tb, tb)
    assert len(rows) == 2 and rows[1].n == tb.trace.n
    assert pbatch.as_trace_batch(tb) is tb
    assert pbatch.as_trace_batch(trs[0]).n_traces == 1


def test_row_band_and_surface_cells_match_reference():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 1 << rdram.ROW_BITS, size=64)
    banks = rng.integers(0, rdram.N_BANKS, size=64)
    cmds = np.full(64, rdram.ACT)
    rtr = rdram.make_trace(cmds, banks, rows)
    from repro.core.energy_model import surface_cells as r_cells
    from repro_torch.core.energy_model import surface_cells as p_cells
    np.testing.assert_array_equal(p_cells(_bridge(rtr)).numpy(),
                                  np.asarray(r_cells(rtr)))
    np.testing.assert_array_equal(
        pdram.row_band(torch.from_numpy(rows)).numpy(),
        np.asarray(rdram.row_band(rows)))


@pytest.mark.parametrize("app_index", range(len(rtraces.SPEC_APPS)))
def test_app_trace_identical_to_reference(app_index):
    """Same seed, same trace, field by field: the reference's lint of its
    own output therefore holds for the port's traces too."""
    app = rtraces.SPEC_APPS[app_index]
    assert dataclasses.astuple(ptraces.SPEC_APPS[app_index]) == \
        dataclasses.astuple(app)
    _assert_trace_equal(rtraces.app_trace(app, n_requests=40),
                        ptraces.app_trace(app, n_requests=40))


def test_sample_lines_identical_to_reference():
    for dist in rtraces.BYTE_DISTS:
        a = rtraces.sample_lines(dist, 9, np.random.default_rng(7))
        b = ptraces.sample_lines(dist, 9, np.random.default_rng(7))
        np.testing.assert_array_equal(a, b, err_msg=dist)
